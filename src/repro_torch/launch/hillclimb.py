"""Hillclimb launcher (port of ``repro/launch/hillclimb.py``): the
roofline mode over the dry run's cells, and the tuners pre-warming their
cache on the card.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        [--cell arch:shape:tag] [--out DIR] [--smoke]
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --spmm \\
        [--n-dense 4] [--full] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --moe
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --attention
    torchrun --nproc-per-node 4 -m repro_torch.launch.hillclimb --dist \\
        --backend gloo

``--spmm`` runs the empirical tuner (``repro_torch.tune``) over the
synthetic matrix suite, timing the port's kernels on ``--device``
(default ``cuda``; ``cpu`` times the plain versions), consulting and
populating the device's cache file under ``REPRO_TUNE_CACHE``: a second
run replays every cell with no tuning measurement.  It prints auto
(static selector) against tuned per cell.  ``--moe`` tunes the MoE
dispatch (``tune.moe``) on the grouped-matmul kernel for a balanced and
a skewed expert histogram of the reference's cells (D 128, F 128, 8
experts top-2, 512 tokens; ``--full`` adds D 256, F 512 and 2048
tokens) and prints the default against the pick; those calls last tens
of microseconds on the card, so they measure the host's launches as
much as the kernel.  ``--attention`` tunes the fused attention kernels,
forward and backward, for a uniform and a skewed pattern.  ``--dist``
tunes the sharded SpMM (``tune_dist_spmm``: local tiling x collective
mode x value dtype) of two random matrices on a reduction mesh over the
whole world, every rank running this command: in a world its caller
initialised, or one this command initialises from torchrun's
environment with the backend named by ``--backend`` (``gloo`` where
ranks share a GPU; with none, the world is this process alone).
``--full`` runs the larger suite.

``--cell arch:shape:tag`` is the roofline mode: it counts the cell under
the variant ``tag`` with the dry run (``launch/dryrun.py``, one rank's
program on ``meta``), counts the baseline too where no record of it at
the same widths exists, and prints the roofline terms before and after;
with no ``--cell`` and no other mode it runs :data:`DEFAULT_PLAN`.
``--out`` names the record directory (default
``experiments/dryrun_torch``); ``--smoke`` counts the arch's smoke
config, whose records go to the directory's ``smoke/``, apart from the
full-width ones.  The variants are the knobs the port has
(:data:`VARIANTS`); the reference's others (``sp``, ``sp_*``, ``inplace``,
``kv2048``) steer what the port does not have, and asking for them
raises, naming why (:data:`REFUSED`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

from ..core.device import resolve_device
from . import dryrun

#: The roofline mode's variants: cfg-level knobs the port has.  The
#: port's ``gc_bf16`` compresses the gradients after their data-parallel
#: all-reduce (``train/train_step.py``), so its collective bytes equal
#: the baseline's: it adds the casts' bytes and saves none on the wire
#: until the step compresses before ``reduce_grads`` (ROADMAP).
VARIANTS = {
    "gc_bf16": {"grad_compression": "bf16"},
    "mb16": {"microbatches": 16},
}

#: The reference's variants that steer what the port does not have, and
#: why.
_SP = ("seq_parallel_attn (Megatron-SP attention) is an XLA sharding "
       "field, which configs/base.py leaves out")
_INPLACE = ("decode_inplace_cache is an XLA buffer field, which "
            "configs/base.py leaves out: the port's decode step writes its "
            "cache in place anyway")
_KV_CHUNK = ("kv_chunk sets the reference's chunked attention loop; the "
             "port's attention is one fused SDPA call and reads no kv_chunk")
REFUSED = {"sp": _SP, "sp_gc": _SP, "sp_mb4": _SP, "inplace": _INPLACE,
           "sp_inplace": _SP, "kv2048": _KV_CHUNK}

#: The reference's hillclimbed cells with the tags the port has.
DEFAULT_PLAN = [
    ("qwen2-7b", "train_4k", ["gc_bf16"]),
]


def _geomean(xs) -> float:
    return float(np.exp(np.mean(np.log(np.maximum(xs, 1e-9)))))


def variant(tag: str) -> dict:
    """The knobs of variant ``tag``; a refused or unknown tag raises."""
    if tag in REFUSED:
        raise ValueError(f"variant {tag!r} is not in the port: "
                         f"{REFUSED[tag]}")
    if tag not in VARIANTS:
        raise ValueError(f"unknown variant {tag!r}; the port has "
                         f"{sorted(VARIANTS)}")
    return VARIANTS[tag]


def _record(path: pathlib.Path):
    return json.loads(path.read_text()) if path.exists() else None


def compare(arch, shape, tag, out_dir=None):
    """Print the baseline's and variant ``tag``'s roofline terms; records
    counted at different widths raise."""
    d = pathlib.Path(out_dir) if out_dir is not None else dryrun.OUT_DIR
    base = json.loads((d / f"{arch}__{shape}__16x16.json").read_text())
    opt = json.loads((d / f"{arch}__{shape}__16x16__{tag}.json").read_text())
    if base.get("overrides") != opt.get("overrides"):
        raise ValueError(f"{arch} × {shape}: the baseline was counted under "
                         f"{base.get('overrides')}, [{tag}] under "
                         f"{opt.get('overrides')}")
    print(f"--- {arch} × {shape} [{tag}] ---")
    for key in ("compute", "memory", "collective"):
        b, o = base["terms_s"][key], opt["terms_s"][key]
        print(f"  {key:10s} {b * 1e3:9.1f} ms -> {o * 1e3:9.1f} ms "
              f"({b / max(o, 1e-12):.2f}x)")
    tb = base["per_chip"]["temp_bytes"] / 1e9
    to = opt["per_chip"]["temp_bytes"] / 1e9
    print(f"  temp       {tb:9.2f} GB -> {to:9.2f} GB")
    print(f"  frac       {base['roofline_fraction']:.4f} -> "
          f"{opt['roofline_fraction']:.4f}")


def _smoke_overrides(arch) -> dict:
    """The fields the arch's smoke config changes."""
    from ..configs import get_config, smoke_config

    cfg = get_config(arch)
    small = smoke_config(cfg)
    return {f.name: getattr(small, f.name)
            for f in dataclasses.fields(cfg)
            if getattr(small, f.name) != getattr(cfg, f.name)}


def cell_hillclimb(plan, out_dir=None, smoke: bool = False):
    """Count each (arch, shape, tags) of ``plan`` under each variant (and
    the baseline where no record of it at the same widths exists) and
    compare.  ``smoke`` counts the arch's smoke config into ``smoke/`` of
    the record directory."""
    d = pathlib.Path(out_dir) if out_dir is not None else dryrun.OUT_DIR
    if smoke:
        d = d / "smoke"
    for arch, shape, tags in plan:
        knobs = [variant(t) for t in tags]  # raise before any count
        ov = _smoke_overrides(arch) if smoke else {}
        base = _record(d / f"{arch}__{shape}__16x16.json")
        if base is None or base.get("overrides") != ov:
            dryrun.run_cell(arch, shape, overrides=ov, out_dir=d)
        for tag, v in zip(tags, knobs):
            dryrun.run_cell(arch, shape, overrides=ov, tag=tag,
                            microbatches=v.get("microbatches", 8),
                            grad_compression=v.get("grad_compression"),
                            out_dir=d)
            compare(arch, shape, tag, d)


def spmm_hillclimb(n_dense: int = 4, quick: bool = True, device=None):
    """Tune schedules for the synthetic suite through the device's
    persistent cache; print auto against tuned per cell and the geomean
    win."""
    from ..core import Schedule
    from ..sparse import matrix_stats, random_csr
    from ..tune import default_cache, measure_schedule, tune_schedule

    dev = resolve_device(device)
    cache = default_cache(dev)
    cells = [(1024 if quick else 4096, d, s)
             for d in (0.002, 0.01) for s in (0.0, 1.5)]
    wins = []
    for m, d, s in cells:
        csr = random_csr(m, m, density=d, skew=s, seed=int(s * 10),
                         device=dev)
        res = tune_schedule(csr, n_dense, cache=cache)
        auto = Schedule.auto(matrix_stats(csr), n_dense)
        t_auto = measure_schedule(csr, n_dense, auto) * 1e6
        wins.append(t_auto / max(res.us_per_call, 1e-9))
        src = "cache" if res.from_cache else f"{res.n_measurements} meas"
        print(f"--- spmm {m}x{m} d={d} skew={s} N={n_dense} [{src}] ---")
        print(f"  auto  {auto}: {t_auto:9.1f} us")
        print(f"  tuned {res.schedule}: {res.us_per_call:9.1f} us "
              f"({wins[-1]:.2f}x)")
    print(f"geomean tuned-vs-auto: {_geomean(wins):.3f}x "
          f"({len(cache)} records in {cache.path})")


def moe_hillclimb(quick: bool = True, device=None):
    """Tune the MoE dispatch for a balanced and a skewed expert histogram
    through the device's persistent cache; print the default against the
    pick per cell and the geomean.  ``ServeEngine.moe_dispatch_schedule``
    replays the records with no measurement."""
    from ..configs import ARCHS, smoke_config
    from ..models.moe import (balanced_expert_lengths, default_dispatch,
                              moe_tune_dispatch, skewed_expert_lengths)
    from ..tune import default_cache
    from ..tune.moe import measure_moe_dispatch, moe_schedule_key

    dev = resolve_device(device)
    cfg = smoke_config(ARCHS["qwen3-moe-235b-a22b"]).scaled(
        d_model=128 if quick else 256, moe_d_ff=128 if quick else 512,
        n_experts=8, experts_per_token=2)
    cache = default_cache(dev)
    cells = []
    for t in ((512,) if quick else (512, 2048)):
        cells.append((f"balanced_t{t}", t, balanced_expert_lengths(cfg, t)))
        cells.append((f"skewed_t{t}", t, skewed_expert_lengths(cfg, t)))
    wins = []
    for name, t, lengths in cells:
        res = moe_tune_dispatch(cfg, t, expert_lengths=lengths, cache=cache,
                                device=dev)
        base = default_dispatch(cfg)
        # the default is always in the measured pool; a replay measured
        # nothing, so it is timed afresh
        t_base = res.measured.get(moe_schedule_key(base))
        if t_base is None:
            t_base = measure_moe_dispatch(
                lengths, cfg.d_model, cfg.moe_d_ff, base,
                dtype=str(cfg.param_dtype), max_tokens=t, device=dev) * 1e6
        wins.append(t_base / max(res.us_per_call, 1e-9))
        src = "cache" if res.from_cache else f"{res.n_measurements} meas"
        print(f"--- moe {name} E={cfg.n_experts} D={cfg.d_model} "
              f"F={cfg.moe_d_ff} [{src}] ---")
        print(f"  default {base}: {t_base:9.1f} us")
        print(f"  tuned   {res.schedule}: {res.us_per_call:9.1f} us "
              f"({wins[-1]:.2f}x)")
    print(f"geomean tuned-vs-default: {_geomean(wins):.3f}x "
          f"({len(cache)} records in {cache.path})")


def attention_hillclimb(quick: bool = True, device=None):
    """Tune the fused attention kernels (fwd and bwd) for a uniform and a
    skewed pattern through the device's persistent cache."""
    from ..sparse import random_csr
    from ..tune import default_cache, tune_sparse_attention

    dev = resolve_device(device)
    cache = default_cache(dev)
    n = 256 if quick else 1024
    d = dv = 16 if quick else 64
    for name, skew in (("uniform", 0.0), ("skewed", 1.5)):
        coo = random_csr(n, n, density=0.05, skew=skew,
                         seed=int(skew * 10), device=dev).tocoo()
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn((n, w), generator=gen, device=dev)
                   for w in (d, d, dv))
        for direction in ("fwd", "bwd"):
            res = tune_sparse_attention(coo.rows, coo.cols, q, k, v,
                                        n_rows=n, direction=direction,
                                        cache=cache)
            src = ("cache" if res.from_cache
                   else f"{res.n_measurements} meas")
            print(f"--- attn {name} {n}x{n} d={d} {direction} [{src}] ---")
            print(f"  tuned {res.schedule}: {res.us_per_call:9.1f} us")
    print(f"({len(cache)} records in {cache.path})")


def dist_hillclimb(n_dense: int = 4, quick: bool = True, device=None):
    """Joint collective x tiling x value-dtype tuning of the sharded SpMM
    on a reduction mesh over the world, through the device's persistent
    cache that ``dist_spmm(..., schedule="tune")`` and
    ``ServeEngine.prepare_dist`` replay from.  Every rank calls it; the
    rank at index 0 prints."""
    from ..sparse import random_csr
    from ..tune import default_cache, tune_dist_spmm
    from .mesh import make_reduction_mesh

    dev = resolve_device(device)
    cache = default_cache(dev)
    mesh = make_reduction_mesh(device=dev)
    axis_size = int(mesh.shape["shards"])
    lead = mesh.axis("shards").index == 0
    n = 512 if quick else 2048
    for d in (0.002, 0.01):
        csr = random_csr(n, n, density=d, seed=7, device="cpu")
        res = tune_dist_spmm(csr, n_dense, mesh=mesh, axis="shards",
                             cache=cache)
        src = "cache" if res.from_cache else f"{res.n_measurements} meas"
        if lead:
            print(f"--- dist {n}x{n} d={d} mesh={axis_size} [{src}] ---")
            print(f"  tuned {res.schedule}: {res.us_per_call:9.1f} us "
                  f"(collective={res.schedule.collective}, "
                  f"value_dtype={res.schedule.value_dtype})")
    if lead:
        print(f"({len(cache)} records in {cache.path})")


def _join_world(backend):
    """Initialise the world from torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) under ``backend``, where
    the caller has not initialised one; with several GPUs a rank takes
    the one of its ``LOCAL_RANK``."""
    import os

    import torch.distributed as dist

    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if backend is None:
        sys.exit("--dist under torchrun needs --backend (gloo where ranks "
                 "share a GPU, nccl for one GPU a rank)")
    if torch.cuda.is_available() and torch.cuda.device_count() > 1:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend=backend)


def main(argv=None):
    """Run the mode the flags name (the roofline mode by default)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--spmm", action="store_true",
                    help="tune sparse schedules on the kernels (populates "
                         "the device's tuner cache)")
    ap.add_argument("--attention", action="store_true",
                    help="tune the fused attention kernels (fwd and bwd)")
    ap.add_argument("--cell", action="append", default=None,
                    help="arch:shape:tag: the roofline mode on one cell "
                         f"(tags {sorted(VARIANTS)})")
    ap.add_argument("--out", default=None,
                    help="--cell: the record directory")
    ap.add_argument("--smoke", action="store_true",
                    help="--cell: count the arch's smoke config")
    ap.add_argument("--moe", action="store_true",
                    help="tune the MoE dispatch on the grouped-matmul kernel")
    ap.add_argument("--dist", action="store_true",
                    help="joint collective x dtype tuning of the sharded "
                         "SpMM on a mesh over the world")
    ap.add_argument("--backend", default=None,
                    help="--dist under torchrun: the process group's "
                         "backend (gloo, nccl)")
    ap.add_argument("--n-dense", type=int, default=4)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.spmm:
        spmm_hillclimb(args.n_dense, quick=not args.full,
                       device=args.device)
    elif args.moe:
        moe_hillclimb(quick=not args.full, device=args.device)
    elif args.attention:
        attention_hillclimb(quick=not args.full, device=args.device)
    elif args.dist:
        _join_world(args.backend)
        dist_hillclimb(args.n_dense, quick=not args.full, device=args.device)
    else:
        plan = DEFAULT_PLAN
        if args.cell:
            plan = []
            for c in args.cell:
                arch, shape, tag = c.split(":")
                plan.append((arch, shape, [tag]))
        cell_hillclimb(plan, out_dir=args.out, smoke=args.smoke)


if __name__ == "__main__":
    main()
