"""What each gloo rank of the port's multi-rank tests runs
(``tests/torch_dist.py`` starts them; JAX is not imported here).

Each function is one test file's group: ``sharding`` (8 ranks, a 2 x 4
mesh), ``compression`` and ``pipeline`` (4 ranks each).  A rank writes what
it computed to ``out / f"{case}{rank}.pt"``; the test process holds it
against the reference.  The inputs are made here from numpy seeds, and the
test process makes the same ones through the ``*_inputs`` functions.
"""
from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import torch

# ---------------------------------------------------------------------------
# sharding: the reference's tests/parallel/test_sharding.py at its 2 x 4 mesh
# ---------------------------------------------------------------------------

# the reference's train-step widths
TRAIN_WIDTHS = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128)
# the row-parallel site alone: K (two runs of K/2 in the nibbles), N, rows
ROW_K, ROW_N, ROW_M = 256, 64, 8
# the sharded W4A8 forwards: kernel sites (the flash emulation of attention,
# or the two-stage kernel's site) or the float emulation of every site
W4A8_CASES = ("kernel-flash", "kernel-two_stage", "fused-flash", "emulation-flash")
# VGGT's scene streams as the reference's vggt cells place them on a mesh
# without "pod" (src/repro/launch/specs.py:269-276): the batch over the data
# axes, or the frames where the data axes do not divide the scenes; each
# with and without the act-SP constraint (the tokens over "model")
VGGT_SPECS = {"batch": ((("data",), None, None, None), None),
              "batch-act_sp": ((("data",), None, None, None), (("data",), None, "model", None)),
              "frames": ((None, "data", None, None), None),
              "frames-act_sp": ((None, "data", None, None), (None, "data", "model", None))}
# 2 scenes x 4 frames x 11 patches (16 tokens a frame: the 4-way model axis
# splits them evenly) and 8 patches (13 tokens: it does not)
VGGT_SHAPES = ((2, 4, 11), (2, 4, 8))
VGGT_TREES = ("fp", "w4a8", "w4a8-two_stage")
# the sequence-sharded decode caches: cache_pspecs' two flags
SEQ_CACHES = {"seq_axis": dict(seq_axis_shard=True),
              "seq_model": dict(seq_axis_shard=False, seq_model_shard=True)}
SEQ_ARCHS = ("qwen3-14b-smoke", "deepseek-v2-lite-16b-smoke", "jamba-v0.1-52b-smoke")
# the kernel wrappers a W4A8 forward reaches: (module of repro_torch.kernels, name)
KERNELS = (("quant_matmul", "quant_matmul"), ("two_stage_attention", "two_stage_attention"),
           ("fused", "fused_matmul"), ("fused", "fused_ffn"))


def _batch_spec(mesh):
    from repro_torch.parallel import sharding

    return lambda path, x: (sharding.batch_axes(mesh),) + (None,) * (x.ndim - 1)


def train_inputs(vocab: int) -> dict:
    g = np.random.default_rng(0)
    return {"tokens": g.integers(0, vocab, (8, 16)), "labels": g.integers(0, vocab, (8, 16))}


def forward_tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, vocab, (4, 8))


def row_site_inputs() -> tuple[np.ndarray, np.ndarray]:
    """Integer activations whose every row reaches +-127 (per-token scale
    exactly 1) and int4 weights: the site's float output is its int32
    product, exactly."""
    g = np.random.default_rng(2)
    x = g.integers(-127, 128, (ROW_M, ROW_K)).astype(np.float32)
    x[:, 5] = 127.0
    w = g.integers(-7, 8, (ROW_K, ROW_N)).astype(np.int8)
    return x, w


def vggt_inputs(b: int, s: int, p: int, d: int) -> dict:
    """Patches and the train step's targets of ``b`` scenes of ``s`` frames
    of ``p`` patches."""
    g = np.random.default_rng(7)
    return {"patches": g.normal(size=(b, s, p, d)).astype(np.float32),
            "pose": g.normal(size=(b, s, 9)).astype(np.float32),
            "depth": g.normal(size=(b, s, p)).astype(np.float32),
            "points": g.normal(size=(b, s, p, 3)).astype(np.float32)}


def _decode_steps(cfg, params, toks, cache, n_prompt: int):
    """The logits of every decode step after a prefill of ``n_prompt``
    tokens, fed the rest of ``toks`` one by one."""
    from repro_torch.models import lm

    _, cache = lm.forward(cfg, params, toks[:, :n_prompt], cache=cache, mode="prefill")
    out = []
    for i in range(n_prompt, toks.shape[1]):
        logits, cache = lm.decode_step(cfg, params, toks[:, i], cache)
        out.append(logits)
    return torch.stack([o.full_tensor() if hasattr(o, "full_tensor") else o for o in out])


def _prefill_decode(cfg, params, toks, nxt, cache):
    """The logits of one decode step on ``nxt`` after a prefill of ``toks``."""
    from repro_torch.models import lm

    _, cache = lm.forward(cfg, params, toks, cache=cache, mode="prefill")
    logits, _ = lm.decode_step(cfg, params, nxt, cache)
    return logits


class _Calls:
    """Records the operands each kernel wrapper got on a sharded path:
    (wrapper, any DTensor operand, K of a ``quant_matmul``'s activations)."""

    def __init__(self):
        self.log: list[tuple[str, bool, int | None]] = []

    def wrap(self, mod, name):
        from repro_torch.sharded import is_dtensor

        inner = getattr(mod, name)

        def rec(*args, **kw):
            self.log.append((name, any(is_dtensor(t) for t in (*args, *kw.values())),
                             args[0].shape[-1] if name == "quant_matmul" else None))
            return inner(*args, **kw)

        setattr(mod, name, rec)
        return inner


def sharding(rank: int, world: int, out) -> None:
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.core.model_quant import quantize_lm, quantize_vggt
    from repro_torch.core.precision import PrecisionPlan
    from repro_torch.core.quantize import QTensor, pack_int4, unpack_int4
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm, vggt
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel import sites
    from repro_torch.runtime.trainer import make_train_step
    from repro_torch.tree import tree_paths

    res: dict = {"times": {}}
    mesh = make_local_mesh(2, world // 2, device_type="cpu")
    bspec = _batch_spec(mesh)

    # (1) the train step at the reference's widths
    t0 = time.perf_counter()
    cfg = get_config("qwen3-14b-smoke").with_(**TRAIN_WIDTHS)
    batch = {k: torch.as_tensor(v) for k, v in train_inputs(cfg.vocab_size).items()}
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    p1, _, m1 = step(lm.init_params(cfg, torch.Generator().manual_seed(0)), adamw.init(params),
                     batch)
    opt = adamw.init(params)
    opt_s = adamw.AdamWState(step=distribute_tensor(opt.step, mesh, sh.placements(mesh, ())),
                             m=sh.distribute_tree(opt.m, mesh), v=sh.distribute_tree(opt.v, mesh))
    with implicit_replication():
        p2, _, m2 = step(sh.distribute_tree(params, mesh), opt_s,
                         sh.distribute_tree(batch, mesh, bspec))
    res["train"] = {"loss1": float(m1["loss"]), "loss2": float(m2["loss"]),
                    "p1": tree_paths(p1), "p2": tree_paths(sh.full_tensor(p2))}
    res["times"]["train"] = time.perf_counter() - t0

    # (2) the W4A8 forward, kernel sites through local_map, and the emulation
    t0 = time.perf_counter()
    qcfg = get_config("qwen3-14b-smoke")
    raw = lm.init_params(qcfg, torch.Generator().manual_seed(0))
    toks = torch.as_tensor(forward_tokens(qcfg.vocab_size))
    calls = _Calls()
    mods = [importlib.import_module(f"repro_torch.kernels.{m}") for m, _ in KERNELS]
    inner = [calls.wrap(mod, name) for mod, (_, name) in zip(mods, KERNELS)]
    for case in W4A8_CASES:
        route, attn = case.split("-")
        cfg = qcfg.with_(attn_impl=attn)
        qp = quantize_lm(cfg, raw, PrecisionPlan(default="w4a8", use_kernel=route != "emulation",
                                                 fuse=route == "fused"))
        with torch.no_grad():
            want, _ = lm.forward(cfg, qp, toks)
            n_plain = len(calls.log)
            with implicit_replication():
                got, _ = lm.forward(cfg, sh.distribute_tree(qp, mesh),
                                    sh.distribute_tree(toks, mesh, bspec))
        res[case] = {"want": want, "got": got.full_tensor(), "calls_plain": calls.log[:n_plain],
                     "calls_sharded": calls.log[n_plain:]}
        calls.log.clear()
    for mod, (_, name), fn in zip(mods, KERNELS, inner):
        setattr(mod, name, fn)
    # the two-stage site on each rank's heads (8 query and 4 K/V heads split
    # 4 ways), against the unsharded wrapper
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, h, 16, 32, generator=g) for h in (8, 4, 4))
    with torch.no_grad():
        qkv = [distribute_tensor(t, mesh, sh.placements(mesh, (("data",), "model")))
               for t in (q, k, v)]
        heads = sites.two_stage_mha(*qkv, causal=True)
    res["two_stage_heads"] = {"got": heads.full_tensor(), "placements": str(heads.placements),
                              "want": ops.two_stage_mha(q, k, v, causal=True)}
    res["times"]["w4a8"] = time.perf_counter() - t0

    # (3) act_sharding: the stream redistributed at every group's end
    fcfg = get_config("qwen3-14b-smoke")
    fp = sh.distribute_tree(raw, mesh)
    ftoks = sh.distribute_tree(toks, mesh, bspec)
    res["act"] = {}
    with torch.no_grad(), implicit_replication():
        base, _ = lm.forward(fcfg, fp, ftoks)
        for seq in (False, True):
            spec = sh.NamedSharding(mesh, sh.act_pspec(mesh, seq_shard=seq))
            got, _ = lm.forward(fcfg, fp, ftoks, act_sharding=spec)
            res["act"][seq] = (base.full_tensor(), got.full_tensor())
        # vggt (weights and scenes replicated): the [B, S, T, d] stream
        # redistributed after every AA pair, against no constraint.  The spec
        # keeps it replicated: on the data axis DTensor 2.13's matmul picks a
        # strided sharding of the flattened rows that it cannot view back
        vcfg = get_config("vggt-1b-smoke")
        vp = sh.distribute_tree(vggt.init_params(vcfg, torch.Generator().manual_seed(0)), mesh,
                                lambda path, x: (None,) * x.ndim)
        scenes = sh.distribute_tree(torch.as_tensor(np.random.default_rng(5).normal(
            size=(2, 2, 8, vcfg.d_model)).astype(np.float32)), mesh,
            lambda path, x: (None,) * x.ndim)
        spec = sh.NamedSharding(mesh, (None, None, None, None))
        vbase = vggt.forward(vcfg, vp, scenes)["points"]
        vgot = vggt.forward(vcfg, vp, scenes, act_sharding=spec)["points"]
        res["act"]["vggt"] = (vbase.full_tensor(), vgot.full_tensor())

    # (3b) a 6-token prefill and a decode step through the int8 KV cache,
    # fp and W4A8 kernel sites, the cache placed by the reference's
    # cache_pspecs (batch over data, head_dim over model) against the
    # unsharded; a cache sharded on its sequence, or left plain, is refused
    res["decode"] = {}
    qp = quantize_lm(qcfg, raw, PrecisionPlan(default="w4a8", use_kernel=True))
    nxt = torch.as_tensor(forward_tokens(qcfg.vocab_size)[:, 6])
    for case, tree in (("fp", raw), ("w4a8", qp)):
        with torch.no_grad():
            want = _prefill_decode(qcfg, tree, toks[:, :6], nxt, lm.init_cache(qcfg, 4, 8))
            cache = lm.init_cache(qcfg, 4, 8)
            specs = sh.cache_pspecs(qcfg, cache, mesh, seq_axis_shard=False)
            with implicit_replication():
                tree_s = fp if case == "fp" else sh.distribute_tree(qp, mesh)
                got = _prefill_decode(qcfg, tree_s, ftoks[:, :6], nxt,
                                      sh.distribute_tree(cache, mesh, sh.spec_at(specs)))
        res["decode"][case] = {"want": want, "got": got.full_tensor()}
    # a cache sharded on its sequence decodes as the unsharded one; a plain
    # cache is refused
    cache = lm.init_cache(qcfg, 4, 8)
    cache = sh.distribute_tree(cache, mesh, sh.spec_at(
        sh.cache_pspecs(qcfg, cache, mesh, seq_axis_shard=True)))
    with torch.no_grad(), implicit_replication():
        got = _prefill_decode(qcfg, fp, ftoks[:, :6], nxt, cache)
    res["decode"]["seq"] = {"want": res["decode"]["fp"]["want"], "got": got.full_tensor()}
    try:
        with torch.no_grad(), implicit_replication():
            _prefill_decode(qcfg, fp, ftoks[:, :6], nxt, lm.init_cache(qcfg, 4, 8))
        res["decode"]["plain"] = None
    except (NotImplementedError, TypeError) as e:
        res["decode"]["plain"] = str(e)

    # (3c) decode through the sequence-sharded caches: GQA, MLA and jamba,
    # fp and W4A8, a 6-token prefill and 3 decode steps against one device
    t0 = time.perf_counter()
    res["seq_decode"] = {}
    for arch in SEQ_ARCHS:
        cfg = get_config(arch)
        raw_a = lm.init_params(cfg, torch.Generator().manual_seed(0))
        toks_a = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 9)))
        for tree in ("fp", "w4a8"):
            p = raw_a if tree == "fp" else quantize_lm(
                cfg, raw_a, PrecisionPlan(default="w4a8", use_kernel=True))
            with torch.no_grad():
                want = _decode_steps(cfg, p, toks_a, lm.init_cache(cfg, 4, 16), 6)
            ps = sh.distribute_tree(p, mesh)
            for mode, flags in SEQ_CACHES.items():
                cache = lm.init_cache(cfg, 4, 16)
                cache = sh.distribute_tree(cache, mesh, sh.spec_at(
                    sh.cache_pspecs(cfg, cache, mesh, **flags)))
                # the reference's decode cells: a batch-1-style replicated
                # token for seq_axis_shard, the batch over data otherwise
                tspec = (None, None) if mode == "seq_axis" else (sh.batch_axes(mesh), None)
                with torch.no_grad(), implicit_replication():
                    got = _decode_steps(cfg, ps, sh.distribute_tree(
                        toks_a, mesh, lambda path, x: tspec), cache, 6)
                res["seq_decode"][(arch, tree, mode)] = {"want": want, "got": got}
    res["times"]["seq_decode"] = time.perf_counter() - t0

    # (3d) vggt on every placement of the reference's vggt cells: the serve
    # forward (fp, W4A8 with the flash emulation and with the two-stage
    # kernel) and a train step (remat, AdamW), against one device
    t0 = time.perf_counter()
    res["vggt"] = {}
    vcfg = get_config("vggt-1b-smoke")
    vraw = vggt.init_params(vcfg, torch.Generator().manual_seed(0))
    for shape in VGGT_SHAPES:
        data = {k: torch.as_tensor(v) for k, v in vggt_inputs(*shape, vcfg.d_model).items()}
        for tree in VGGT_TREES + ("train",):
            cfg = vcfg.with_(attn_impl="two_stage") if tree.endswith("two_stage") else vcfg
            p = vraw if tree in ("fp", "train") else quantize_vggt(
                cfg, vraw, PrecisionPlan(default="w4a8", use_kernel=True))
            if tree == "train":
                step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3), loss_fn=lambda q, b: (
                    vggt.reconstruction_loss(cfg, q, b, remat=True)))
                p1, _, m1 = step(vggt.init_params(cfg, torch.Generator().manual_seed(0)),
                                 adamw.init(vraw), data)
                want = {"loss": float(m1["loss"]), "params": tree_paths(p1)}
            else:
                with torch.no_grad():
                    want = vggt.forward(cfg, p, data["patches"])
            for name, (bspec, aspec) in VGGT_SPECS.items():
                act = None if aspec is None else sh.NamedSharding(mesh, aspec)
                batch_s = {k: sh.distribute_tree(v, mesh, lambda path, x: bspec[:x.ndim])
                           for k, v in data.items()}
                with implicit_replication():
                    if tree == "train":
                        params = vggt.init_params(cfg, torch.Generator().manual_seed(0))
                        opt = adamw.init(params)
                        opt_s = adamw.AdamWState(
                            step=distribute_tensor(opt.step, mesh, sh.placements(mesh, ())),
                            m=sh.distribute_tree(opt.m, mesh), v=sh.distribute_tree(opt.v, mesh))
                        step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3),
                                               loss_fn=lambda q, b, act=act: (
                            vggt.reconstruction_loss(cfg, q, b, remat=True, act_sharding=act)))
                        p2, _, m2 = step(sh.distribute_tree(params, mesh), opt_s, batch_s)
                        loss = m2["loss"]
                        got = {"loss": float(loss.full_tensor()), "params": tree_paths(
                            sh.full_tensor(p2))}
                    else:
                        with torch.no_grad():
                            heads = vggt.forward(cfg, sh.distribute_tree(p, mesh),
                                                 batch_s["patches"], act_sharding=act)
                        got = {k: heads[k].full_tensor() for k in ("pose", "depth", "points")}
                res["vggt"][(shape, tree, name)] = {
                    "want": want if tree == "train" else {k: want[k] for k in got}, "got": got}
    res["times"]["vggt"] = time.perf_counter() - t0

    # (4) one row-parallel W4 site alone: the two nibble runs, exact ints
    x, w = row_site_inputs()
    wq = QTensor(values=pack_int4(torch.as_tensor(w)), scale=torch.ones(1, ROW_N), bits=4,
                 packed=True)
    row = sh.param_pspec("blocks.l0.mixer.wo.qw.values", wq.values)
    wq_s = dataclasses.replace(
        wq, values=distribute_tensor(wq.values, mesh, sh.placements(mesh, row)),
        scale=distribute_tensor(wq.scale, mesh, sh.placements(mesh, (None, None))))
    xs = distribute_tensor(torch.as_tensor(x), mesh, sh.placements(mesh, (None, "model")))
    with torch.no_grad():
        got = sites.quant_linear_matmul(xs, wq_s)
    local_rows = wq_s.values.to_local().shape[0]
    res["row_site"] = {"got": got.full_tensor(), "placements": str(got.placements),
                       "columns": sites.row_columns(ROW_K, local_rows,
                                                    mesh.get_local_rank(1), packed=True)}

    # (5) unpack_int4 of a replicated DTensor, and a wrapper given a DTensor
    packed = pack_int4(torch.as_tensor(w))
    rep = distribute_tensor(packed, mesh, sh.placements(mesh, (None, None)))
    res["unpack"] = {"plain": unpack_int4(packed), "dtensor": unpack_int4(rep).full_tensor()}
    try:
        ops.quant_linear_matmul(xs, wq_s)
        res["refused"] = None
    except TypeError as e:
        res["refused"] = str(e)
    torch.save(res, out / f"sharding{rank}.pt")


# ---------------------------------------------------------------------------
# compression: tests/parallel/test_compression.py on 4 ranks
# ---------------------------------------------------------------------------

EF_STEPS, DDP_STEPS = 40, 25
DDP_WIDTHS = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                  vocab_size=32)


def psum_inputs(world: int) -> list[np.ndarray]:
    """The first step's [world, 1000] gradients, then EF_STEPS more."""
    rng = np.random.default_rng(0)
    return [rng.normal(size=(world, 1000)).astype(np.float32) for _ in range(EF_STEPS + 1)]


def compression(rank: int, world: int, out) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, token_batch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.parallel import compression as comp
    from repro_torch.runtime.trainer import make_ddp_compressed_step, make_train_step

    res: dict = {}
    grads = psum_inputs(world)
    group = dist.group.WORLD
    e = torch.zeros(1000)
    outs, errs = [], []
    for g in grads:
        o, e = comp.compressed_psum(torch.as_tensor(g[rank]), group, world, e)
        outs.append(o)
        errs.append(e)
    res["psum"] = {"out": torch.stack(outs), "err": torch.stack(errs)}

    tree = {"small": torch.full((4, 10), float(rank + 1)), "big": torch.tensor(grads[0][rank])}
    err0 = comp.init_error_state(tree)
    m, e2 = comp.compressed_tree_psum(tree, err0, group, world)
    res["tree"] = {"small": m["small"], "big": m["big"], "err_small": e2["small"],
                   "err_big": e2["big"], "in_place": m is tree and e2 is err0}

    cfg = get_config("qwen3-14b-smoke").with_(**DDP_WIDTHS)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    opt_cfg = adamw.AdamWConfig(lr=5e-3, warmup_steps=3, total_steps=DDP_STEPS)
    dc = DataConfig(vocab_size=32, batch=8, seq_len=16)
    mesh = make_local_mesh(world, 1, device_type="cpu")
    step_c = make_ddp_compressed_step(cfg, opt_cfg, mesh)
    p, opt, err = params, adamw.init(params), comp.init_error_state(params)
    losses = []
    t0 = time.perf_counter()
    for s in range(DDP_STEPS):
        p, opt, err, met = step_c(p, opt, err, token_batch(dc, s))
        losses.append(float(met["loss"]))
    res["ddp"] = {"losses": losses, "seconds": time.perf_counter() - t0,
                  "wire_bytes": comp.wire_bytes(params, world)}
    if rank == 0:  # the uncompressed single-device baseline
        step_b = make_train_step(cfg, opt_cfg)
        p2 = lm.init_params(cfg, torch.Generator().manual_seed(0))
        o2 = adamw.init(p2)
        base = []
        for s in range(DDP_STEPS):
            p2, o2, met = step_b(p2, o2, token_batch(dc, s))
            base.append(float(met["loss"]))
        res["ddp"]["base"] = base
    torch.save(res, out / f"compression{rank}.pt")


# ---------------------------------------------------------------------------
# pipeline: tests/parallel/test_pipeline.py on 4 ranks
# ---------------------------------------------------------------------------

PIPE_S, PIPE_B, PIPE_D, PIPE_MICRO = 4, 8, 16, 4


def pipeline_inputs() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(PIPE_S, PIPE_D, PIPE_D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(PIPE_B, PIPE_D)).astype(np.float32)
    return w, x


def stage_fn(p: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return torch.tanh(h @ p)


def pipeline(rank: int, world: int, out) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.pipeline import pipeline_apply

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pipe",))
    w, x = pipeline_inputs()
    got = pipeline_apply(mesh, stage_fn, torch.as_tensor(w), torch.as_tensor(x),
                         n_micro=PIPE_MICRO)
    torch.save({"got": got}, out / f"pipeline{rank}.pt")
