"""No kernel of the port has a backward (the reference's Pallas kernels
define none), so each wrapper of ``kernels/ops.py`` refuses a tensor that
requires grad, here on the CPU as on the card: otherwise the CPU's plain
versions would backpropagate while the card's kernels silently returned
tensors without a ``grad_fn``.  A trained tree serves once detached, which
``runtime.trainer.make_train_step`` leaves it."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.model_quant import quantize_vggt
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.core.quantize import quantize_weight
from repro_torch.kernels import ops
from repro_torch.models import vggt
from repro_torch.tree import tree_index, tree_map
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CFG = get_config("vggt-1b-smoke").with_(n_layers=1)


@pytest.fixture(scope="module")
def fused_block():
    params = vggt.init_params(CFG, torch.Generator().manual_seed(0))
    q = quantize_vggt(CFG, params, PrecisionPlan(default="w4a8", use_kernel=True, fuse=True))
    return tree_index(q["blocks"], 0)["frame"]


def _x(*shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(1))


def _calls(block):
    d = CFG.d_model
    wq = quantize_weight(_x(d, 64) / 8, 4)
    q = _x(1, 4, 16, 32)
    return {
        "quant_linear_matmul": lambda x: ops.quant_linear_matmul(x, wq),
        "two_stage_mha": lambda x: ops.two_stage_mha(x, q, q),
        "online_wht_2d": lambda x: ops.online_wht_2d(x),
        "fused_linear": lambda x: ops.fused_linear(x, block["attn"]["wqkv"]),
        "fused_ffn_apply": lambda x: ops.fused_ffn_apply(x, block["ffn"]),
        "norm_quant_prologue": lambda x: ops.norm_quant_prologue(x, norm="rms", wht=True),
    }, {"two_stage_mha": (1, 4, 16, 32)}.get


@pytest.mark.parametrize("wrapper", ["quant_linear_matmul", "two_stage_mha", "online_wht_2d",
                                     "fused_linear", "fused_ffn_apply", "norm_quant_prologue"])
def test_wrapper_refuses_input_that_requires_grad(fused_block, wrapper):
    calls, shape = _calls(fused_block)
    x = _x(*(shape(wrapper) or (8, CFG.d_model)))
    calls[wrapper](x)  # a detached input runs the plain version here
    with pytest.raises(RuntimeError, match=f"{wrapper}: .*no kernel has a backward"):
        calls[wrapper](x.requires_grad_(True))


def test_quantized_parameters_that_require_grad_are_refused():
    """A tree quantized from parameters that still require grad (a bias is
    carried over as it is) is refused at its first kernel."""
    params = tree_map(lambda p: p.requires_grad_(True),
                      vggt.init_params(CFG, torch.Generator().manual_seed(0)))
    q = quantize_vggt(CFG, params, PrecisionPlan(default="w4a8", use_kernel=True, fuse=True))
    with pytest.raises(RuntimeError, match="no kernel has a backward"):
        vggt.forward(CFG, q, _x(1, 2, 16, CFG.d_model))
    detached = tree_map(lambda p: p.detach(), q)
    assert torch.isfinite(vggt.forward(CFG, detached, _x(1, 2, 16, CFG.d_model))["pose"]).all()
