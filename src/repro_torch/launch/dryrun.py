"""Multi-pod dry run: run every (arch x shape x mesh) cell's step on a fake
256- or 512-rank mesh and read its roofline terms (port of
``repro/launch/dryrun.py``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out results/dryrun_torch]

``--all`` drives one subprocess per cell (a fresh process group each
time, results cached as JSON under ``--out``); single-cell mode does the
work in-process.  A CPU-only tool: the production mesh of
``launch/mesh.py`` (16 x 16, or 2 x 16 x 16 for ``multi``) is built over
the ``fake`` backend (``torch.testing._internal.distributed.fake_pg``: one
process, no devices, collectives that move nothing), the cell's arguments
are DTensors over ``meta`` tensors (``launch/specs.py``), and the step
runs eagerly, at full depth, under ``roofline_util.StepCounter``, which
reads rank 0's FLOPs, bytes and collectives at local shapes.  Eager
execution runs every layer, so the reference's extrapolation from reduced
depths (``specs.reduced_cfg``) is not needed.

The time recurrences loop over the sequence in Python, one step a token
(``models/rwkv.py::wkv_recurrence``, ``models/ssm.py::_selective_scan``):
32,768 steps a layer in ``prefill_32k``.  Inside the dry run only they are
replaced by stand-ins with the same output shapes and placements
(:func:`time_scan_standins`), and their FLOPs come from
``roofline_util.time_scan_flops``, divided over the ranks, exactly as the
reference adds them.  The stand-ins leave out the recurrences' own bytes:
each step's read and write of the f32 state ([B, H, dh, dh] for WKV,
[B, d_inner, d_state] for the scan) and its per-token inputs.

Every term is modelled from data-sheet constants (``roofline_util``), not
measured.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

ASSIGNED_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
VGGT_CELL_SHAPES = ["vggt_serve_s8", "vggt_serve_s32", "vggt_train_s4"]
FLAGS = (("--no-sp", "no_sp"), ("--zero1", "zero1"), ("--no-remat", "no_remat"),
         ("--remat-dots", "remat_dots"), ("--kv-bf16", "kv_bf16"), ("--fp-serve", "fp_serve"),
         ("--act-sp", "act_sp"), ("--kv-seq-model", "kv_seq_model"),
         ("--attn-bf16", "attn_bf16"))


@contextlib.contextmanager
def time_scan_standins():
    """The WKV recurrence and the selective scan replaced by ops with their
    outputs' shapes and placements (the module docstring says what they
    leave out); restored on exit."""
    import torch

    from repro_torch.models import rwkv, ssm

    def wkv(r, k, v, w, u, s):
        # y [B, L, H, dh] as r; the state [B, H, dh, dh] as s
        return r * u[None, None].to(r.dtype), w[:, -1, :, :, None] * s

    def scan(u, dt, a, b_in, c_in, d_skip, init_state=None):
        # y [B, L, di] as u; the state [B, di, ds] from the last step's dt
        h = dt[:, -1, :, None] * a.to(torch.float32)
        return u * d_skip, h if init_state is None else h + init_state

    saved = rwkv.wkv_recurrence, ssm._selective_scan
    rwkv.wkv_recurrence, ssm._selective_scan = wkv, scan
    try:
        yield
    finally:
        rwkv.wkv_recurrence, ssm._selective_scan = saved


def _peak_bytes(fn, args) -> tuple:
    """(the step's peak bytes on one rank from ``MemTracker``, or None, and
    a note).  ``torch.distributed._tools.mem_tracker`` is a private API:
    any failure reports None with its reason."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker

        mt = MemTracker()
        with mt:
            fn(*args)
        snap = mt.get_tracker_snapshot("peak")
        dev = max(snap.values(), key=lambda d: d.get("Total", 0))
        return int(dev.get("Total", 0)), "MemTracker peak (private API)"
    except Exception as e:  # noqa: BLE001 - a private API; the reason is reported
        return None, f"MemTracker unavailable: {type(e).__name__}: {str(e)[:200]}"


def _log(collectives) -> list:
    """The collectives issued, grouped: [[kind, result shape, group size,
    intra-node, count], ...] in first-issue order."""
    seen: dict = {}
    for kind, shape, _, size, intra in collectives:
        key = (kind, shape, size, intra)
        seen[key] = seen.get(key, 0) + 1
    return [[k[0], list(k[1]), k[2], k[3], n] for k, n in seen.items()]


def run_cell(arch: str, shape: str, mesh_kind: str, opts: dict) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.launch import roofline_util as ru
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    ok, why = specs.applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "skipped",
                "reason": why}
    n_chips = 512 if mesh_kind == "multi" else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_chips)
    try:
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
        t0 = time.time()
        cell = specs.make_cell(cfg, shape, mesh, **opts)
        t_build = time.time() - t0
        sh = specs.SHAPES[shape]
        grad = sh.kind in ("train", "vggt_train")
        counter = ru.StepCounter()
        t0 = time.time()
        with time_scan_standins(), implicit_replication(), torch.set_grad_enabled(grad):
            with counter:
                cell.fn(*cell.args)
            t_run = time.time() - t0
            peak, peak_note = _peak_bytes(cell.fn, cell.args)
    finally:
        dist.destroy_process_group()

    print(f"--- {arch} x {shape} x {mesh_kind} ---")
    res = ru.extract(counter)
    # the time recurrences' FLOPs, which the stand-ins do not run
    corr = ru.time_scan_flops(cfg, sh.kind, sh.seq, sh.batch) / n_chips
    rl = ru.Roofline(flops=res["flops_per_dev"] + corr, hbm_bytes=res["hbm_bytes_per_dev"],
                     coll_bytes=res["coll_bytes_per_dev"],
                     coll_bytes_intra=res["collectives"]["intra_node"]).as_dict()
    mf = ru.model_flops(cfg, sh.kind, sh.seq, sh.batch)
    rl.update(
        arch=arch,
        shape=shape,
        mesh=mesh_kind,
        status="ok",
        n_chips=n_chips,
        n_layers=cfg.n_layers,
        build_s=round(t_build, 1),
        run_s=round(t_run, 1),
        time_scan_flops_corr_per_dev=corr,
        model_flops_total=mf,
        model_flops_per_dev=mf / n_chips,
        useful_flops_ratio=(mf / n_chips) / max(rl["flops_per_dev"], 1.0),
        collectives=res["collectives"],
        collective_log=_log(counter.collectives),
        memory={**{f"{k}_bytes": v for k, v in cell.held.items()},
                "held_bytes": sum(cell.held.values()), "peak_bytes": peak,
                "peak_note": peak_note},
        opts={k: str(v) for k, v in opts.items()},
    )
    return rl


def _opts(args) -> dict:
    opts: dict = {}
    if args.no_sp:
        opts["seq_sp"] = False
    if args.zero1:
        opts["zero1"] = True
    if args.no_remat:
        opts["remat"] = False
    if args.remat_dots:
        opts["remat"] = "dots"
    if args.attn:
        opts["attn"] = args.attn
    if args.kv_bf16:
        import torch

        opts["kv_dtype"] = torch.bfloat16
    for key in ("fp_serve", "act_sp", "kv_seq_model", "attn_bf16"):
        if getattr(args, key):
            opts[key] = True
    return opts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--force", action="store_true")
    # hillclimb options
    ap.add_argument("--no-sp", action="store_true",
                    help="disable TP sequence sharding of activations")
    ap.add_argument("--zero1", action="store_true", help="shard optimizer state over data axis")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-dots", action="store_true", help="dots_saveable remat policy")
    ap.add_argument("--attn", default=None, choices=[None, "vanilla", "flash", "two_stage"])
    ap.add_argument("--kv-bf16", action="store_true", help="bf16 KV cache (unquantized baseline)")
    ap.add_argument("--fp-serve", action="store_true", help="bf16 weights for serve cells")
    ap.add_argument("--act-sp", action="store_true", help="TP-SP residual sharding in prefill")
    ap.add_argument("--kv-seq-model", action="store_true",
                    help="decode: shard cache seq over model")
    ap.add_argument("--attn-bf16", action="store_true", help="bf16 streaming-attention compute")
    ap.add_argument("--timeout", type=int, default=2400)
    args = ap.parse_args(argv)
    opts = _opts(args)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        from repro_torch.configs import ASSIGNED

        cells = [(a, s) for a in ASSIGNED for s in ASSIGNED_SHAPES]
        # the paper's own model, with frame-count shapes
        cells += [("vggt-1b", s) for s in VGGT_CELL_SHAPES]
        os.makedirs(args.out, exist_ok=True)
        failures = []
        for arch, shape in cells:
            for mesh_kind in meshes:
                name = f"{arch}__{shape}__{mesh_kind}__{args.tag}.json"
                if os.path.exists(os.path.join(args.out, name)) and not args.force:
                    print("cached:", name)
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                       "--shape", shape, "--mesh", mesh_kind, "--out", args.out,
                       "--tag", args.tag]
                cmd += [flag for flag, key in FLAGS if getattr(args, key)]
                if args.attn:
                    cmd += ["--attn", args.attn]
                print(">>", " ".join(cmd), flush=True)
                try:
                    r = subprocess.run(cmd, timeout=args.timeout)
                    if r.returncode != 0:
                        failures.append(name)
                except subprocess.TimeoutExpired:
                    failures.append(name + " (timeout)")
        if failures:
            print("FAILED cells:", failures)
            sys.exit(1)
        print("all cells ok")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    for mesh_kind in meshes:
        try:
            res = run_cell(args.arch, args.shape, mesh_kind, opts)
        except Exception:
            res = {"arch": args.arch, "shape": args.shape, "mesh": mesh_kind,
                   "status": "error", "traceback": traceback.format_exc()}
        os.makedirs(args.out, exist_ok=True)
        name = f"{args.arch}__{args.shape}__{mesh_kind}__{args.tag}.json"
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps({k: v for k, v in res.items()
                          if k not in ("traceback", "collectives", "collective_log", "memory")},
                         indent=1))
        if res["status"] == "error":
            print(res["traceback"])
            sys.exit(1)


if __name__ == "__main__":
    main()
