"""The port's partition rules and sharded execution (``parallel/sharding.py``,
``parallel/sites.py``, ``launch/mesh.py``) against the JAX package's.

The rules need no devices: ``param_pspec`` / ``make_param_pspecs`` /
``make_opt_pspecs`` equal the reference's ``PartitionSpec`` for every leaf
of the float tree of all 22 configs at full size (the port's tree built on
``meta``, the reference's through ``jax.eval_shape``; no weights drawn), and
of the W4A8 trees of the smoke configs; ``cache_pspecs`` on ``init_cache``
trees of every LM family, on the production mesh of the ``fake`` backend
(256 ranks) against a ``jax.sharding.AbstractMesh`` of the same shape.

Sharded equals single device: the reference's two scripts of
``tests/parallel/test_sharding.py`` at its 2 x 4 (data x model) mesh, on 8
gloo ranks started once for the file (``tests/torch_ranks.py::sharding``),
the port's sharded run held to the port's single-device run, which the
other ``test_torch_*`` files hold to the reference: the train step at the
reference's widths (loss ``rtol=1e-4``, every leaf ``rtol=atol=5e-3``) and
the W4A8 ``qwen3-14b-smoke`` forward (the reference's structural bound),
its kernel sites through ``local_map`` on local shards.  One row-parallel
W4 site alone is exact in integers; ``act_sharding`` moves nothing beyond
float summation order; ``unpack_int4`` of a DTensor is the plain result; a
wrapper refuses a DTensor.  VGGT runs on every scene-stream placement of
the reference's vggt cells (serve and a train step), and decode runs
through KV caches sharded on their sequence (GQA, MLA, jamba), each against
one device."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import torch_ranks
from repro.configs import get_config as j_get_config
from repro.core.model_quant import quantize_lm as j_quantize_lm
from repro.core.model_quant import quantize_vggt as j_quantize_vggt
from repro.core.versaq import W4A8 as J_W4A8
from repro.models import lm as jlm
from repro.models import vggt as jvggt
from repro.parallel import sharding as jsh
from repro_torch.configs import get_config, list_configs
from repro_torch.core.model_quant import quantize_lm, quantize_vggt
from repro_torch.core.versaq import W4A8
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm, vggt
from repro_torch.parallel import sharding
from repro_torch.tree import tree_paths
from torch_dist import run_ranks
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CONFIGS = list_configs()
SMOKE = [c for c in CONFIGS if c.endswith("-smoke")]
LM_SMOKE = [c for c in SMOKE if not c.startswith("vggt")]
# (seq_axis_shard, seq_model_shard)
CACHE_MODES = [(False, False), (True, False), (False, True)]
# the reference's bounds (tests/parallel/test_sharding.py)
LOSS_RTOL, LEAF_TOL = 1e-4, 5e-3
FLIP_DIFF, FLIP_FRAC, MAX_DIFF = 2e-2, 0.01, 0.25
# the stream redistributed at group ends against not: summation order only
ACT_TOL = 1e-5


def _ref_flat(tree) -> dict:
    """{dotted path: leaf} of a JAX tree whose leaves may be PartitionSpecs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {".".join(jsh._path_names(p)): leaf for p, leaf in flat}


def _port_flat(specs, like, prefix: str = "") -> dict:
    """{dotted path: spec} of the port's spec tree ``specs``, walked along
    the tensor tree ``like`` it was made from (a spec is a tuple, which the
    tree helpers would walk into)."""
    out: dict = {}

    def walk(s, t, p):
        if isinstance(t, torch.Tensor):
            out[p] = s
        elif isinstance(t, dict):
            for k in t:
                walk(s[k], t[k], f"{p}.{k}" if p else str(k))
        elif isinstance(t, tuple) and hasattr(type(t), "_fields"):
            for f in t._fields:
                walk(getattr(s, f), getattr(t, f), f"{p}.{f}" if p else f)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(s[i], v, f"{p}.{i}" if p else str(i))
        elif dataclasses.is_dataclass(t):
            for f in dataclasses.fields(t):
                walk(getattr(s, f.name), getattr(t, f.name), f"{p}.{f.name}" if p else f.name)

    walk(specs, like, prefix)
    return out


@functools.lru_cache(maxsize=None)
def _trees(arch: str, quantized: bool):
    """(the port's tree on meta, the reference's abstract tree)."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    key = jax.random.PRNGKey(0)
    model, jmodel = (vggt, jvggt) if jcfg.vggt else (lm, jlm)
    port = model.init_params(cfg, torch.Generator(), device="meta")
    ref = jax.eval_shape(lambda: jmodel.init_params(jcfg, key))
    if quantized:
        quant, jquant = ((quantize_vggt, j_quantize_vggt) if jcfg.vggt
                         else (quantize_lm, j_quantize_lm))
        port = quant(cfg, port, W4A8)
        ref = jax.eval_shape(lambda p: jquant(jcfg, p, J_W4A8), ref)
    return port, ref


def _hold_params(arch: str, quantized: bool) -> dict:
    port, ref = _trees(arch, quantized)
    want = {".".join(jsh._path_names(path)): tuple(jsh.param_pspec(path, leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = {p: sharding.param_pspec(p, x) for p, x in tree_paths(port).items()}
    assert sorted(got) == sorted(want)
    assert {p: (got[p], want[p]) for p in want if got[p] != want[p]} == {}
    tree_form = _port_flat(sharding.make_param_pspecs(port), port)
    assert tree_form == got
    want_tree = {p: tuple(s) for p, s in _ref_flat(jsh.make_param_pspecs(ref)).items()}
    assert tree_form == want_tree
    return got


@pytest.mark.parametrize("arch", CONFIGS)
def test_param_pspecs_equal_the_reference_on_every_float_tree(arch):
    got = _hold_params(arch, quantized=False)
    assert any("model" in s for s in got.values())


@pytest.mark.parametrize("arch", SMOKE)
def test_param_pspecs_equal_the_reference_on_the_w4a8_trees(arch):
    got = _hold_params(arch, quantized=True)
    assert any(p.endswith("qw.values") for p in got)
    assert any(p.endswith("qw.scale") for p in got)


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("arch", CONFIGS)
def test_opt_pspecs_equal_the_reference(arch, zero1):
    port, ref = _trees(arch, False)
    got = _port_flat(sharding.make_opt_pspecs(port, zero1=zero1), port)
    want = {p: tuple(s) for p, s in _ref_flat(jsh.make_opt_pspecs(ref, zero1=zero1)).items()}
    assert got == want
    assert any("data" in s for s in got.values()) == zero1


@pytest.fixture(scope="module")
def fake_mesh():
    """The production mesh over 256 ranks of the ``fake`` backend (no
    devices, no processes), and a reference AbstractMesh of its shape."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        yield make_production_mesh(device_type="cpu"), jax.sharding.AbstractMesh(
            (16, 16), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_the_fake_backend(multi_pod):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=n - 1, world_size=n)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))
        assert mesh.size() == n
        assert sharding.batch_axes(mesh) == (("pod", "data") if multi_pod else ("data",))
        jmesh = jax.sharding.AbstractMesh(tuple(mesh.shape), mesh.mesh_dim_names)
        assert sharding.batch_pspec(mesh) == tuple(jsh.batch_pspec(jmesh))
        for seq in (False, True):
            assert sharding.act_pspec(mesh, seq_shard=seq) == tuple(
                jsh.act_pspec(jmesh, seq_shard=seq))
        assert sharding.placements(mesh, ("model", None)) == (
            Replicate(),) * (mesh.ndim - 1) + (Shard(0),)
        assert sharding.placements(mesh, (("pod", "data"), "model")) == (
            (Shard(0),) * (mesh.ndim - 1) + (Shard(1),))
        port, _ = _trees("qwen3-14b", False)
        named = _port_flat(sharding.make_param_shardings(mesh, port), port)
        for path, x in tree_paths(port).items():
            assert named[path].mesh is mesh
            assert named[path].placements == sharding.placements(
                mesh, sharding.param_pspec(path, x)), path
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("modes", CACHE_MODES, ids=lambda m: f"seq_axis={m[0]}-seq_model={m[1]}")
@pytest.mark.parametrize("arch", LM_SMOKE)
def test_cache_pspecs_equal_the_reference(fake_mesh, arch, modes):
    mesh, jmesh = fake_mesh
    seq_axis, seq_model = modes
    cfg, jcfg = get_config(arch), j_get_config(arch)
    cache = lm.init_cache(cfg, 2, 16)
    jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, 2, 16))
    got = _port_flat(sharding.cache_pspecs(cfg, cache, mesh, seq_axis_shard=seq_axis,
                                           seq_model_shard=seq_model), cache)
    want = {p: tuple(s) for p, s in _ref_flat(jsh.cache_pspecs(
        jcfg, jcache, jmesh, seq_axis_shard=seq_axis, seq_model_shard=seq_model)).items()}
    # the write positions are host ints in the port (int32 scalars there)
    clocks = {p for p in want if p == "pos" or p.endswith(".length")}
    assert all(want[p] in ((), (None,)) for p in clocks)
    assert got == {p: s for p, s in want.items() if p not in clocks}


# ---------------------------------------------------------------------------
# sharded equals single device, on 8 gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding_ranks")
    seconds = run_ranks(8, "sharding", out, timeout=900)
    res = [torch.load(out / f"sharding{r}.pt", weights_only=False) for r in range(8)]
    print(f"8 gloo ranks: {seconds:.1f}s, rank 0 {res[0]['times']}")
    return res


def test_sharded_train_step_matches_single_device(ranks):
    for r in ranks:
        t = r["train"]
        np.testing.assert_allclose(t["loss2"], t["loss1"], rtol=LOSS_RTOL)
        assert sorted(t["p2"]) == sorted(t["p1"])
        for p, want in t["p1"].items():
            np.testing.assert_allclose(t["p2"][p].numpy(), want.numpy(), rtol=LEAF_TOL,
                                       atol=LEAF_TOL, err_msg=p)
    worst = max(float((ranks[0]["train"]["p2"][p] - x).abs().max())
                for p, x in ranks[0]["train"]["p1"].items())
    print(f"sharded train step: loss {ranks[0]['train']['loss2']:.7f} vs "
          f"{ranks[0]['train']['loss1']:.7f}, worst leaf |diff| {worst:.3g}")


@pytest.mark.parametrize("case", torch_ranks.W4A8_CASES)
def test_quantized_serving_sharded_matches(ranks, case):
    for r in ranks:
        d = r[case]
        diff = (d["got"] - d["want"]).abs()
        frac = float((diff > FLIP_DIFF).float().mean())
        assert frac < FLIP_FRAC, ("bin-flip fraction", frac)
        assert float(diff.max()) < MAX_DIFF, ("max deviation", float(diff.max()))
        plain, sharded = d["calls_plain"], d["calls_sharded"]
        if case.startswith("emulation"):
            assert plain == sharded == []
            continue
        # every site of the sharded forward called its kernel wrapper on
        # local shards, once a site, as the unsharded forward does
        assert [n for n, _, _ in sharded] == [n for n, _, _ in plain]
        assert not any(dt for _, dt, _ in plain + sharded)
        # the row-parallel sites (wo, w_down of 2 layers) took their K runs,
        # a quarter of K on the 4-way model axis; a fused site runs replicated
        ks = [(k, kp) for (_, _, k), (_, _, kp) in zip(sharded, plain) if k != kp]
        assert all(4 * k == kp for k, kp in ks)
        assert len(ks) == (0 if case.startswith("fused") else 4)
        n_attn = sum(n == "two_stage_attention" for n, _, _ in sharded)
        assert n_attn == (2 if case.endswith("two_stage") else 0)
        assert any(n.startswith("fused") for n, _, _ in sharded) == case.startswith("fused")
    d = ranks[0][case]
    print(f"sharded W4A8 forward ({case}): max |diff| "
          f"{float((d['got'] - d['want']).abs().max()):.3g} over max |logit| "
          f"{float(d['want'].abs().max()):.3g}")


def test_two_stage_site_attends_with_each_ranks_heads(ranks):
    for r in ranks:
        t = r["two_stage_heads"]
        assert torch.equal(t["got"], t["want"])
        assert t["placements"] == "(Shard(dim=0), Shard(dim=1))"


@pytest.mark.parametrize("case", ["fp", "w4a8"])
def test_sharded_decode_through_the_kv_cache_matches(ranks, case):
    """A prefill and a decode step, the int8 KV cache placed by
    ``cache_pspecs(seq_axis_shard=False)``, under the W4A8 forward's
    structural bound against the unsharded."""
    for r in ranks:
        d = r["decode"][case]
        diff = (d["got"] - d["want"]).abs()
        assert float((diff > FLIP_DIFF).float().mean()) < FLIP_FRAC
        assert float(diff.max()) < MAX_DIFF, float(diff.max())
    d = ranks[0]["decode"][case]
    print(f"sharded decode ({case}): max |diff| {float((d['got'] - d['want']).abs().max()):.3g} "
          f"over max |logit| {float(d['want'].abs().max()):.3g}")


def test_sequence_sharded_or_plain_cache_is_refused(ranks):
    """A cache sharded on its sequence decodes as the unsharded one (each
    rank writes its own slots); a plain one cannot take a sharded forward's
    writes and raises rather than decode wrong."""
    for r in ranks:
        d = r["decode"]["seq"]
        diff = (d["got"] - d["want"]).abs()
        assert float((diff > FLIP_DIFF).float().mean()) < FLIP_FRAC
        assert float(diff.max()) < MAX_DIFF, float(diff.max())
        assert "writes a plain cache" in r["decode"]["plain"]


@pytest.mark.parametrize("mode", list(torch_ranks.SEQ_CACHES))
@pytest.mark.parametrize("tree", ["fp", "w4a8"])
@pytest.mark.parametrize("arch", torch_ranks.SEQ_ARCHS)
def test_decode_through_a_sequence_sharded_cache_matches(ranks, arch, tree, mode):
    """A 6-token prefill and 3 decode steps through a KV cache placed by
    ``cache_pspecs(seq_axis_shard=True)`` or ``seq_model_shard=True``: each
    rank writes the slots it holds and the ranks combine their partial
    softmaxes; held to the unsharded decode under the W4A8 forward's
    structural bound (jamba's int8 cache flips one K entry by a step at
    layer 3 in fp too, with the cache placed by the batch as well)."""
    for r in ranks:
        d = r["seq_decode"][(arch, tree, mode)]
        diff = (d["got"] - d["want"]).abs()
        assert d["got"].shape == d["want"].shape == (3, 4, 1, d["want"].shape[-1])
        assert float((diff > FLIP_DIFF).float().mean()) < FLIP_FRAC
        assert float(diff.max()) < MAX_DIFF, float(diff.max())
    d = ranks[0]["seq_decode"][(arch, tree, mode)]
    print(f"{arch} {tree} {mode}: max |diff| {float((d['got'] - d['want']).abs().max()):.3g} "
          f"over max |logit| {float(d['want'].abs().max()):.3g}")


@pytest.mark.parametrize("spec", list(torch_ranks.VGGT_SPECS))
@pytest.mark.parametrize("tree", torch_ranks.VGGT_TREES + ("train",))
@pytest.mark.parametrize("shape", torch_ranks.VGGT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vggt_on_every_placement_matches(ranks, shape, tree, spec):
    """vggt-1b-smoke on each scene-stream placement of the reference's vggt
    cells (batch or frames over data, with and without the act-SP spec),
    against one device: the fp forward to ``ACT_TOL``, the W4A8 forwards
    (kernel sites, flash emulation or the two-stage kernel) under the
    structural bound, and a train step (remat, AdamW) under the train
    step's bounds."""
    for r in ranks:
        d = r["vggt"][(shape, tree, spec)]
        want, got = d["want"], d["got"]
        if tree == "train":
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
            assert sorted(got["params"]) == sorted(want["params"])
            for p, w in want["params"].items():
                np.testing.assert_allclose(got["params"][p].numpy(), w.numpy(), rtol=LEAF_TOL,
                                           atol=LEAF_TOL, err_msg=p)
            continue
        for k, w in want.items():
            assert got[k].shape == w.shape, k
            if tree == "fp":
                np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=ACT_TOL, atol=ACT_TOL,
                                           err_msg=k)
            else:
                diff = (got[k] - w).abs()
                assert float((diff > FLIP_DIFF).float().mean()) < FLIP_FRAC, k
                assert float(diff.max()) < MAX_DIFF, (k, float(diff.max()))


def test_row_parallel_w4_site_is_exact_in_integers(ranks):
    x, w = torch_ranks.row_site_inputs()
    want = torch.as_tensor(x.astype(np.int64) @ w.astype(np.int64)).to(torch.float32)
    for rank, r in enumerate(ranks):
        s = r["row_site"]
        assert torch.equal(s["got"], want)
        assert s["placements"] == "(Replicate(), Replicate())"
        # rank (d, m)'s packed rows hold K-runs [32 m, 32 m + 32) and K/2 past it
        m, h = rank % 4, torch_ranks.ROW_K // 8
        run = torch.arange(m * h, (m + 1) * h)
        assert torch.equal(s["columns"], torch.cat([run, run + torch_ranks.ROW_K // 2]))


@pytest.mark.parametrize("case", [False, True, "vggt"], ids=["lm", "lm_seq_shard", "vggt"])
def test_act_sharding_moves_nothing(ranks, case):
    for r in ranks:
        base, got = r["act"][case]
        np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=ACT_TOL, atol=ACT_TOL)


def test_unpack_int4_of_a_dtensor_and_the_wrappers_refusal(ranks):
    for r in ranks:
        assert torch.equal(r["unpack"]["dtensor"], r["unpack"]["plain"])
        assert r["refused"] is not None and "got a DTensor" in r["refused"]
