"""The plain references against the port's own plain path (its kernels'
plain PyTorch versions on the CPU) at smoke size: the reference imports
nothing of the port; this test does, to compare."""
import numpy as np
import torch

from portbench.drivers import lm as lm_driver
from portbench.drivers import vggt as vggt_driver
from portbench.reference import lm as ref_lm
from portbench.reference import vggt as ref_vggt
from portbench.smoke import LM

# two AA pairs at d = 128: shallow enough that rounding does not cascade
VGGT = dict(arch="vggt-1b-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
            d_ff=256)


# At d = 128 one int8 activation that rounds the other way (the port's kernels
# and the reference sum in different orders) moves pose by ~1e-5; the W4A4
# control reads 1e-3 and more at this size.
TOL = 1e-4


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_vggt_reference_matches_the_served_w4a8_fused_tier():
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.serving.vggt_engine import VGGTEngine

    cfg = vggt_driver.model_config(dict(VGGT, layerscale_init=0.01))
    raw = vggt_driver.make_weights(cfg, 11, "cpu")
    eng = VGGTEngine(cfg, raw, tiers={"t": ServeSpec.parse("w4a8:fused").materialize()},
                     attn_impl="two_stage", device="cpu")
    x = vggt_driver.make_scenes(11, 0, 2, 2, 16, cfg.d_model, "cpu")
    out = eng.infer(x)
    want = ref_vggt.forward(vggt_driver.plain_tree(raw),
                            {"d_model": cfg.d_model, "n_heads": cfg.n_heads, "d_ff": cfg.d_ff,
                             "n_special_tokens": 5},
                            [x[0], x[1]])
    for i, w in enumerate(want):
        for k in ("pose", "depth", "points", "conf"):
            assert _rel(out[k][i], w[k]) < TOL, (i, k)


def test_lm_reference_matches_the_served_w4a8_prefill():
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.serving import engine as E

    cfg = lm_driver.model_config(LM)
    raw = lm_driver.make_weights(cfg, 12, "cpu")
    got = {}
    orig = E.PrefillRunner.run

    def run(self, reqs, L, tier):
        res = orig(self, reqs, L, tier)
        for i, r in enumerate(reqs):
            got[r.req_id] = res.logits_last[i].clone()
        return res

    E.PrefillRunner.run = run
    try:
        eng = E.Engine(cfg, raw, tiers={"t": ServeSpec.parse("w4a8").materialize()},
                       device="cpu", mode="continuous", max_len=64, batch_buckets=(1, 2),
                       max_batch=2)
        prompts = [np.random.default_rng(i).integers(0, 512, n) for i, n in enumerate((32, 16))]
        reqs = [eng.enqueue(p, 1) for p in prompts]
        eng.flush()
    finally:
        E.PrefillRunner.run = orig
    want = ref_lm.last_logits(lm_driver.plain_tree(raw),
                              {"d_model": 128, "n_heads": 4, "n_kv_heads": 4, "head_dim": 32,
                               "rope_theta": cfg.rope_theta},
                              [torch.from_numpy(p) for p in prompts])
    for r, w in zip(reqs, want):
        assert _rel(got[r.req_id], w) < TOL
        assert int(r.result()[0]) == int(w.argmax())
