"""The port's dry run (``launch/specs.py`` cells, ``launch/roofline_util.py``
terms, ``launch/dryrun.py``) against the JAX package's.

The pure parts equal the reference's for every config of the registry and
every shape: ``SHAPES``, ``applicable``, ``reduced_cfg``, ``model_flops``,
``time_scan_flops``.  The collective counter reproduces the reference's
``test_collective_parser`` numbers from collectives issued on a ``fake``
process group.  ``make_cell`` runs each shape kind on a 2 x 4 fake mesh at
the reference test's reduced widths (``tests/launch/test_dryrun_smoke.py``)
with every term > 0, and a dense prefill on a 1 x 1 mesh counts the FLOPs a
hand count from the config gives.  The reference's own cell test compiles
on 8 fake JAX devices and fails on this JAX (ROADMAP, queue 3), so the
cells are held to their terms, not to the reference's."""
import dataclasses
import math

import pytest
import torch
import torch.distributed as dist

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import get_config as j_get_config
from repro.launch import roofline_util as jru
from repro.launch import specs as jspecs
from repro_torch.configs import ASSIGNED, get_config, list_configs
from repro_torch.launch import dryrun, roofline_util as ru, specs
from repro_torch.launch.mesh import make_local_mesh
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CONFIGS = list_configs()
# the reference test's reduced widths and shapes (test_dryrun_smoke.py:14-24)
WIDTHS = dict(d_model=256, n_heads=8, n_kv_heads=2, head_dim=32, d_ff=512)
SMALL = {"train_4k": (8, 64), "prefill_32k": (4, 128), "decode_32k": (8, 128),
         "long_500k": (1, 256), "vggt_serve_s8": (2, 2), "vggt_serve_s32": (1, 4),
         "vggt_train_s4": (2, 2)}


@pytest.fixture
def fake_group():
    """A ``fake`` process group of ``n`` ranks (this process is rank 0),
    destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(n: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)

    try:
        yield init
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_shapes_and_assigned_equal_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in specs.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jspecs.SHAPES.items()}
    assert list(specs.VGGT_SHAPES) == list(jspecs.VGGT_SHAPES)
    assert specs.VGGT_PATCHES == jspecs.VGGT_PATCHES
    assert specs.SUBQUADRATIC == jspecs.SUBQUADRATIC
    assert ASSIGNED == J_ASSIGNED
    assert dryrun.ASSIGNED_SHAPES + dryrun.VGGT_CELL_SHAPES == list(jspecs.SHAPES)


@pytest.mark.parametrize("arch", CONFIGS)
def test_applicable_equals_the_reference(arch):
    for shape in specs.SHAPES:
        assert specs.applicable(get_config(arch), shape) == jspecs.applicable(
            j_get_config(arch), shape), shape


@pytest.mark.parametrize("arch", CONFIGS)
def test_reduced_cfg_equals_the_reference(arch):
    for g in (1, 2, 3):
        got, want = specs.reduced_cfg(get_config(arch), g), jspecs.reduced_cfg(
            j_get_config(arch), g)
        assert (got.n_layers, got.first_dense, got.pattern) == (
            want.n_layers, want.first_dense, tuple(want.pattern))
        assert got.param_counts() == want.param_counts()


@pytest.mark.parametrize("arch", CONFIGS)
def test_model_flops_equal_the_reference(arch):
    for sh in specs.SHAPES.values():
        assert ru.model_flops(get_config(arch), sh.kind, sh.seq, sh.batch) == jru.model_flops(
            j_get_config(arch), sh.kind, sh.seq, sh.batch), sh.name


@pytest.mark.parametrize("arch", CONFIGS)
def test_time_scan_flops_equal_the_reference(arch):
    for sh in specs.SHAPES.values():
        got = ru.time_scan_flops(get_config(arch), sh.kind, sh.seq, sh.batch)
        assert got == jru.time_scan_flops(j_get_config(arch), sh.kind, sh.seq, sh.batch)
        if get_config(arch).family in ("rwkv",) or "mamba" in get_config(arch).pattern:
            assert got > 0, sh.name


def test_collective_counter_reproduces_the_reference_parser(fake_group):
    """The reference's ``test_collective_parser`` numbers (all-gather
    f32[256,128] over 4 ranks, all-reduce bf16[64] over 8, reduce-scatter
    f32[32,16] over 4), from collectives issued on a fake group and read
    by ``StepCounter``; the reference's parser reads the same from HLO."""
    from torch.distributed import _functional_collectives as funcol

    fake_group(16)
    g4, g8 = dist.new_group(list(range(4))), dist.new_group(list(range(8)))
    meta = dict(device="meta")
    with ru.StepCounter() as c:
        funcol.all_gather_tensor(torch.empty(64, 128, **meta), 0, g4)
        funcol.all_reduce(torch.empty(64, dtype=torch.bfloat16, **meta), "sum", g8)
        funcol.reduce_scatter_tensor(torch.empty(128, 16, **meta), "sum", 0, g4)
    res = ru.extract(c)["collectives"]
    want = jru.collective_bytes("""
  %all-gather.1 = f32[256,128]{1,0} all-gather(%x), replica_groups=[4,4]<=[16], dimensions={0}
  %all-reduce.2 = bf16[64]{0} all-reduce(%y), replica_groups=[2,8]<=[16]
  %rs = f32[32,16]{1,0} reduce-scatter(%z), replica_groups={{0,1,2,3}}, dimensions={0}
""")
    ag, ar, rs = 256 * 128 * 4 * (3 / 4), 2 * 64 * 2 * (7 / 8), 32 * 16 * 4 * 3
    for kind, b in (("all-gather", ag), ("all-reduce", ar), ("reduce-scatter", rs)):
        assert abs(res["per_kind"][kind] - b) < 1, kind
        assert abs(want["per_kind"][kind] - b) < 1, kind
        assert res["count"][kind] == 1
    assert abs(res["total"] - (ag + ar + rs)) < 1
    # ranks 0-3 and 0-7 share one 8-GPU node
    assert res["intra_node"] == res["total"]


def test_flops_are_counted_at_local_shapes(fake_group):
    """The rule: each op is counted at the local shapes a rank runs it on.
    A [16, 64, 128] @ [128, 256] @ [256, 128] chain, the batch over data
    and the weights column- then row-parallel over model on a 2 x 4 mesh,
    counts a rank's share: 1/8 of the global FLOPs (the row-parallel
    output stays a partial sum, with no collective yet); replicated, all of
    them."""
    from torch.distributed.tensor import Replicate, Shard

    fake_group(8)
    mesh = make_local_mesh(2, 4)
    f32 = dict(dtype=torch.float32, device="meta")
    x, w1, w2 = (torch.empty(s, **f32) for s in ((16, 64, 128), (128, 256), (256, 128)))
    glob = 2 * 16 * 64 * 128 * 256 * 2
    for pls, share in (([(Shard(0), Replicate()), (Replicate(), Shard(1)),
                         (Replicate(), Shard(0))], 8),
                       ([(Replicate(), Replicate())] * 3, 1)):
        xs, a, b = (specs.place(t, mesh, lambda p, t, pl=pl: _spec_of(pl, t.ndim))
                    for t, pl in zip((x, w1, w2), pls))
        with ru.StepCounter() as c:
            (xs @ a) @ b
        assert c.flops == glob / share
        assert c.collectives == []


def _spec_of(placements, ndim: int) -> tuple:
    """The spec of ``placements`` on a (data, model) mesh."""
    from torch.distributed.tensor import Shard

    spec = [None] * ndim
    for ax, pl in zip(("data", "model"), placements):
        if isinstance(pl, Shard):
            spec[pl.dim] = ax
    return tuple(spec)


def _run(cell):
    from torch.distributed.tensor.experimental import implicit_replication

    counter = ru.StepCounter()
    grad = "train" in cell.shape
    with dryrun.time_scan_standins(), implicit_replication(), torch.set_grad_enabled(grad):
        with counter:
            cell.fn(*cell.args)
    return ru.extract(counter)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k",
                                        "vggt_serve_s8", "vggt_train_s4"])
def test_make_cell_runs_each_shape_kind(fake_group, monkeypatch, shape_name):
    fake_group(8)
    mesh = make_local_mesh(2, 4)
    b, s = SMALL[shape_name]
    monkeypatch.setitem(specs.SHAPES, shape_name, dataclasses.replace(
        specs.SHAPES[shape_name], batch=b, seq=s))
    vggt = shape_name.startswith("vggt")
    cfg = get_config("vggt-1b-smoke" if vggt else "qwen3-14b-smoke")
    cfg = cfg if vggt else cfg.with_(**WIDTHS)
    cell = specs.make_cell(cfg, shape_name, mesh)
    assert (cell.arch, cell.shape) == (cfg.name, shape_name)
    assert cell.held["params"] > 0 and cell.held["batch"] > 0
    res = _run(cell)
    assert res["flops_per_dev"] > 0, shape_name
    assert res["hbm_bytes_per_dev"] > 0, shape_name
    assert res["coll_bytes_per_dev"] > 0, shape_name  # TP always communicates
    assert res["dominant"] in ("compute", "memory", "collective")
    print(shape_name, res["dominant"], {k: res[k] for k in ("flops_per_dev",
                                                          "coll_bytes_per_dev")})


def test_dense_prefill_counts_the_hand_count(fake_group, monkeypatch):
    """A bf16 prefill on a 1 x 1 mesh counts, to 1e-6, the projections
    (q, k, v, o, the FFN's three, the LM head) plus QKᵀ and P·V over the
    whole [L, L] (one flash chunk: L < 1024 keys)."""
    fake_group(1)
    mesh = make_local_mesh(1, 1)
    b, seq = 2, 128
    monkeypatch.setitem(specs.SHAPES, "prefill_32k", dataclasses.replace(
        specs.SHAPES["prefill_32k"], batch=b, seq=seq))
    cfg = get_config("qwen3-14b-smoke").with_(**WIDTHS)
    res = _run(specs.make_cell(cfg, "prefill_32k", mesh, fp_serve=True))
    d, h, hkv, dh, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                            cfg.vocab_size)
    t = b * seq
    proj = 2 * t * (d * h * dh + 2 * d * hkv * dh + h * dh * d + 3 * d * ff)
    attn = 2 * 2 * b * h * seq * seq * dh
    want = cfg.n_layers * (proj + attn) + 2 * t * d * v
    assert math.isclose(res["flops_per_dev"], want, rel_tol=1e-6), (res["flops_per_dev"], want)
    assert res["coll_bytes_per_dev"] == 0


@pytest.mark.parametrize("arch,kv_seq_model", [("jamba-v0.1-52b-smoke", False),
                                               ("qwen3-14b-smoke", True)])
def test_sequence_sharded_decode_gathers_no_cache(fake_group, monkeypatch, arch, kv_seq_model):
    """A decode cell through a cache sharded on its sequence (``long_500k``'s
    batch 1: over data; ``--kv-seq-model``: over model) on a 2 x 4 fake
    mesh: the ranks combine partial softmaxes, and no collective's result
    spans the cache's whole sequence."""
    fake_group(8)
    mesh = make_local_mesh(2, 4)
    seq = 384  # no width of the smoke configs
    monkeypatch.setitem(specs.SHAPES, "long_500k", dataclasses.replace(
        specs.SHAPES["long_500k"], batch=1 if not kv_seq_model else 2, seq=seq))
    cell = specs.make_cell(get_config(arch), "long_500k", mesh, kv_seq_model=kv_seq_model)
    from torch.distributed.tensor.experimental import implicit_replication

    with dryrun.time_scan_standins(), implicit_replication(), torch.no_grad():
        with ru.StepCounter() as c:
            cell.fn(*cell.args)
    shapes = [shape for _, shape, *_ in c.collectives]
    assert not [s for s in shapes if seq in s]
    # the combine: a max and two sums of [B, 1, H, 1] and [B, 1, H, dh] partials
    assert any(kind == "all-reduce" and len(shape) == 4 and shape[-1] == 1
               for kind, shape, *_ in c.collectives)


def test_time_scan_standins_keep_the_shapes():
    """Inside the dry run the WKV loop and the selective scan are replaced
    by ops with their outputs' shapes."""
    from repro_torch.models import rwkv, ssm

    g = torch.Generator().manual_seed(0)
    r, k, v, w = (torch.rand(2, 5, 3, 4, generator=g) for _ in range(4))
    u, s = torch.rand(3, 4, generator=g), torch.rand(2, 3, 4, 4, generator=g)
    x, dt = torch.rand(2, 5, 6, generator=g), torch.rand(2, 5, 6, generator=g)
    a, bc = torch.rand(6, 4, generator=g), torch.rand(2, 5, 4, generator=g)
    loops = rwkv.wkv_recurrence, ssm._selective_scan
    real = loops[0](r, k, v, w, u, s), loops[1](x, dt, a, bc, bc, torch.rand(6))
    with dryrun.time_scan_standins():
        fake = (rwkv.wkv_recurrence(r, k, v, w, u, s),
                ssm._selective_scan(x, dt, a, bc, bc, torch.rand(6)))
    assert (rwkv.wkv_recurrence, ssm._selective_scan) == loops  # restored
    for got, want in zip(fake, real):
        assert [t.shape for t in got] == [t.shape for t in want]
        assert [t.dtype for t in got] == [t.dtype for t in want]


def test_a_skipped_cell_reports_applicables_reason(tmp_path, capsys):
    dryrun.main(["--arch", "qwen3-14b", "--shape", "long_500k", "--out", str(tmp_path)])
    import json

    res = json.loads((tmp_path / "qwen3-14b__long_500k__single__baseline.json").read_text())
    assert res["status"] == "skipped"
    assert res["reason"] == jspecs.applicable(j_get_config("qwen3-14b"), "long_500k")[1]
