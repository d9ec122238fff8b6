"""Dry run: count every (arch x shape) cell of the production mesh, one
rank's program at full width on the ``meta`` device (port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k [--multi-pod] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs N]

Where the reference lowers and compiles the global program for XLA's
partitioner, the port has one program a rank (``distributed/sharding.py``
says how it applies the reference's specs: in every family the
vocab-sharded embedding, the FSDP attention weights, the dense MLP's
split or the experts over ``model``, the mamba rules, the caches' splits
and the batch over the data axes; in a training cell, unless
``--no-zero1``, ZeRO-1's moments over the data axes).  A cell here is the
program of the rank at the mesh's first coordinates, on a dry mesh
(``launch.mesh.make_dry_mesh``): its parameters (``init_params`` on
``meta``, the rank's blocks),
the global batch of which the entry points take the rank's block, and
the step run eagerly under ``roofline.analysis.count_costs``, which
counts its FLOPs, bytes, collective bytes (the FSDP all-gathers and
their reduce-scatters, the tensor-parallel all-reduces, the vocabulary's
and the cache's combines) and peak; a training step recomputes its
layers under the configs' ``remat=True``, as the reference's.  Nothing is
allocated and no kernel runs: the MoE runs its einsum path
(``moe_kernel_dispatch=False``), as the reference's dry run lowers its
einsum path, since the grouped-matmul kernel's dispatch reads the
routing's histogram.

The layers run in a Python loop, so every cell is counted at its whole
depth: the reference's L=1/L=2 ladder (XLA counts a scan body once) and
its single-chunk attention pass are not needed, since eager code counts
every layer and every product.  A line through two depths would also
misread the peak wherever the phase that peaks changes with depth.
``--jobs N`` counts the cells in N processes.

Records land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``--out`` elsewhere) with the reference's keys, ``fits``: whether the
rank's arguments and its counted peak fit one card's memory,
``applied``: the spec groups the rank's program applies, ``savings``:
what each spec still unapplied would take off its arguments
(:func:`unapplied_savings`, ``{}`` where every spec is applied: a guard
that shows a spec a later change stops applying), ``zero1_applied``:
whether the rank's moments are ZeRO-1's blocks, and ``overrides``: the
config fields the
cell was counted under ({} at the catalog's widths).
``roofline/report.py`` prints the tables.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import pathlib
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from fractions import Fraction

import torch

from ..configs import (ARCHS, SHAPES, batch_from_specs, cell_is_runnable,
                       decode_specs, get_config, train_batch_specs)
from ..core.tree import key_str, tree_leaves, tree_leaves_with_path
from ..distributed import sharding
from ..distributed.sharding import (  # noqa: F401
    _axes_of,
    cache_shardings,
    data_axes,
    param_shardings,
    zero1_shardings,
)
from ..models import get_model
from ..models.moe import ShardingCtx
from ..roofline.analysis import (H100, analyze, count_active_params,
                                 count_costs,
                                 count_params, link_bw_for, tree_bytes)
from ..train.optimizer import AdamW, cosine_schedule
from ..train.train_step import TrainState, make_train_step, zero1_shapes
from .mesh import make_production_mesh

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")

#: The parameter spec groups a record names (applied, or unapplied with
#: their savings), by leaf path.
SPEC_GROUPS = (("embed", "vocab-sharded embedding"),
               ("attn/", "FSDP attention"),
               ("mlp/", "dense MLP split"),
               ("mixer/", "mamba rules"))
#: The names of the expert rule's group, the caches' and ZeRO-1's.
EXPERT_GROUP, KV_GROUP = "expert-parallel MoE", "sequence-sharded KV cache"
STATE_GROUP, ZERO1_GROUP = "mamba state over model", "ZeRO-1 moments"


def _spec_count(mesh, spec) -> int:
    n = 1
    for e in spec:
        for a in (_axes_of(e) if e else ()):
            n *= mesh.shape[a]
    return n


def make_ctx(cfg, mesh, *, collective=None, block_batch: bool = True):
    """The rank's ``ShardingCtx`` on ``mesh``: the batch over the data
    axes, the model axis (the applied specs' blocks over it and the data
    axes; a replicated leaf's gradient averaged over it too) and, for
    the MoE, the combine ``collective`` (None: 'nnz_ar').  The
    reference's holds only the MoE's: its partitioner shards the rest.
    ``block_batch`` False hands every rank the whole batch (one that
    does not split)."""
    dispatch = None
    if cfg.family == "moe" and collective is not None:
        from ..tune.moe import MoeDispatchSchedule

        dispatch = MoeDispatchSchedule(capacity_factor=cfg.capacity_factor,
                                       collective=collective)
    return ShardingCtx(mesh=mesh,
                       data_axes=data_axes(mesh) if block_batch else (),
                       model_axis="model", moe_dispatch=dispatch)


def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def _rank_params(api, cfg, mesh, device, seed):
    """The rank's parameters: its blocks under the applied specs; on meta
    the shapes alone, on a real device drawn from ``seed``."""
    gen = (torch.Generator() if device.type == "meta" else
           torch.Generator(device=device).manual_seed(seed))
    return api.init(gen, device=device, mesh=mesh)


def _inputs(specs: dict, device, seed) -> dict:
    """``specs`` themselves on meta; a batch drawn from ``seed`` on a
    real device."""
    if device.type == "meta":
        return specs
    return batch_from_specs(specs, torch.Generator().manual_seed(seed),
                            device=device)


@dataclasses.dataclass
class Program:
    """One rank's step of a cell: ``run()`` runs it once and returns its
    outputs; ``args`` are the tensors it holds before it starts (its
    state and its block of the batch)."""

    run: object
    args: object


def lower_cell(arch: str, shape, *, multi_pod: bool = False,
               zero1: bool = True, overrides: dict | None = None,
               microbatches: int = 8, grad_compression: str | None = None,
               collective: str | None = None, mesh=None, device="meta",
               seed: int = 0):
    """Build one (arch x shape x mesh) cell's rank program.  ``shape`` is
    a name of ``SHAPES`` or a ``ShapeConfig`` (a cut of one).  Returns
    (:class:`Program`, meta), or (None, the skip record).  ``mesh``
    replaces the production mesh (e.g. a (1, 1) mesh: one rank holding
    the whole cell).  On ``device="meta"`` the program holds shapes
    alone; on a real device the same program on parameters and a batch
    drawn from ``seed``, which counts the same."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, dry=True)
    dev = torch.device(device)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return None, {"skipped": why, "arch": arch, "shape": shape.name}
    cfg = cfg.scaled(moe_kernel_dispatch=False)
    api = get_model(cfg)
    whole = api.init(torch.Generator(), device="meta")
    params = _rank_params(api, cfg, mesh, dev, seed)
    n_chips = math.prod(mesh.shape.values())
    dp = _dp_size(mesh)
    pshard = param_shardings(mesh, whole)
    meta = {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(str(n) for n in mesh.shape.values()),
        "kind": shape.kind, "n_chips": n_chips,
        "tokens": (shape.global_batch if shape.kind == "decode"
                   else shape.tokens),
        "n_params": count_params(whole),
        "n_active_params": count_active_params(whole, cfg),
        "microbatches": microbatches if shape.kind == "train" else None,
        "grad_compression": grad_compression,
        "moe_collective": ((collective or "nnz_ar")
                           if cfg.family == "moe" else None),
        "zero1": bool(zero1 and shape.kind == "train"),
        "zero1_applied": bool(zero1 and shape.kind == "train"),
    }
    block = shape.global_batch % dp == 0
    ctx = make_ctx(cfg, mesh, collective=collective, block_batch=block)
    b_loc = shape.global_batch // dp if block else shape.global_batch

    if shape.kind == "train":
        opt = AdamW(lr=cosine_schedule(3e-4, 2000, 100_000))
        state = TrainState(params=params, opt=opt.init(
            params, zero1_shapes(mesh, api, whole) if zero1 else None))
        specs = _inputs(train_batch_specs(cfg, shape), dev, seed)
        step = make_train_step(api, opt, ctx, microbatches=microbatches,
                               grad_compression=grad_compression)
        meta["applied"] = applied_groups(mesh, whole, params,
                                         moments=state.opt.mu)
        meta["savings"] = unapplied_savings(
            mesh, cfg, whole, pshard, params=params, moments=state.opt.mu,
            zero1=zero1)
        return Program(lambda: step(state, specs),
                       (state, _blocks(ctx, specs))), meta

    if shape.kind == "prefill":
        specs = _inputs(train_batch_specs(cfg, shape), dev, seed)
        meta["applied"] = applied_groups(mesh, whole, params)
        meta["savings"] = unapplied_savings(mesh, cfg, whole, pshard,
                                            params=params)

        def prefill():
            with torch.no_grad():
                return api.prefill(params, specs, shape.seq_len, ctx)

        return Program(prefill, (params, _blocks(ctx, specs))), meta

    # decode: one new token against a full cache of the rank's slots and
    # its blocks over the model axis
    cache = api.init_cache(b_loc, shape.seq_len, device=dev, ctx=ctx)
    cache["pos"] = shape.seq_len - 1
    whole_cache = api.init_cache(b_loc, shape.seq_len, device="meta")
    tokens = _inputs({"t": decode_specs(cfg, shape, api.init_cache)[
        "tokens"]}, dev, seed)["t"]
    meta["applied"] = applied_groups(mesh, whole, params, cache=cache,
                                     whole_cache=whole_cache)
    meta["savings"] = unapplied_savings(mesh, cfg, whole, pshard,
                                        params=params, cache=cache,
                                        whole_cache=whole_cache)

    def decode():
        with torch.no_grad():
            return api.decode_step(params, cache, tokens, ctx)

    return Program(decode, (params, cache, _blocks(ctx, {"t": tokens}))), \
        meta


def _blocks(ctx, specs: dict) -> dict:
    if not ctx.data_axes:
        return specs
    return {k: sharding.data_block(ctx.mesh, ctx.data_axes, v)
            for k, v in specs.items()}


def _group_of(name: str):
    if "moe/" in name:
        return EXPERT_GROUP
    return next((g for key, g in SPEC_GROUPS if key in name), None)


def _cache_group(name: str) -> str:
    return STATE_GROUP if "ssm" in name or "conv" in name else KV_GROUP


def _held(whole, held) -> dict:
    """{path: how many blocks of its whole leaf the rank's leaf is} of
    every leaf of the rank's tree ``held`` (1: whole)."""
    sizes = {key_str(p): v.numel() for p, v in tree_leaves_with_path(whole)
             if isinstance(v, torch.Tensor)}
    return {key_str(p): sizes[key_str(p)] // max(v.numel(), 1)
            for p, v in tree_leaves_with_path(held)
            if isinstance(v, torch.Tensor)}


def applied_groups(mesh, whole, params, *, moments=None, cache=None,
                   whole_cache=None) -> list:
    """The spec groups the rank's program applies, read from what it
    holds: each group of :data:`SPEC_GROUPS` (and the experts) with a
    leaf the rank holds a block of (``params`` against the whole tree
    ``whole``), ZeRO-1 where a moment is a smaller block than its
    parameter, and the caches' groups where a leaf of the rank's
    ``cache`` is a block of ``whole_cache``'s (the batch of both is the
    rank's slots)."""
    out = []

    def add(group):
        if group not in out:
            out.append(group)

    for name, n in _held(whole, params).items():
        if n > 1:
            add(_group_of(name))
    if moments is not None and (
            sum(m.numel() for m in tree_leaves(moments))
            < sum(p.numel() for p in tree_leaves(params))):
        add(ZERO1_GROUP)
    if cache is not None:
        for name, n in _held(whole_cache, cache).items():
            if n > 1:
                add(_cache_group(name))
    return out


def unapplied_savings(mesh, cfg, whole, pshard, *, params, moments=None,
                      zero1=False, cache=None, whole_cache=None) -> dict:
    """Bytes a rank's arguments would lose under each of the reference's
    specs it does not apply, read from what the rank holds (``params``,
    and training ``moments``, against the whole tree ``whole``; the
    ``cache`` against ``whole_cache`` of the same slots), each alone,
    largest first: by group of parameter rules (:data:`SPEC_GROUPS`; a
    leaf the rank holds in ``have`` blocks that the reference splits in
    ``n`` keeps ``have / n`` of it, and of its f32 moments up to the
    group's own split), ZeRO-1 (``zero1``: the moments over the data
    axes beyond their parameter's spec, :func:`zero1_shardings`, summed
    over the leaves: under a layer split a rank holds its layers' moments
    whole and the others' not at all), and
    the cache's blocks over ``model`` (``cache_shardings``; its batch is
    the rank's slots already).  ``{}`` where every spec is applied: the
    record's guard."""
    out = {}

    def add(group, nbytes):
        if nbytes > 0:
            out[group] = out.get(group, 0) + nbytes

    zspecs = zero1_shardings(mesh, whole, pshard) if zero1 else None
    have = _held(whole, params)
    held_m = ({} if moments is None else
              {key_str(p): m.numel() for p, m in tree_leaves_with_path(
                  moments)})
    excess = {}  # moment bytes held beyond the reference's, by group
    for path, leaf in tree_leaves_with_path(whole):
        name = key_str(path)
        elems = leaf.numel()
        n = _spec_count(mesh, pshard[name])
        group = _group_of(name) or "other specs"
        if n > have[name]:
            add(group, elems * leaf.element_size() * (n - have[name])
                // (n * have[name]))
        if name not in held_m:
            continue
        ref = zspecs[name] if zspecs is not None else pshard[name]
        bucket = group if n > have[name] or zspecs is None else ZERO1_GROUP
        excess[bucket] = excess.get(bucket, 0) + 8 * (
            held_m[name] - Fraction(elems, _spec_count(mesh, ref)))
    for bucket, nbytes in excess.items():
        add(bucket, int(nbytes))
    if cache is not None:
        cspec = cache_shardings(mesh, cfg, whole_cache)
        sizes = {key_str(p): v for p, v in tree_leaves_with_path(whole_cache)}
        for name, h in _held(whole_cache, cache).items():
            split = any("model" in _axes_of(e) for e in cspec[name] if e)
            n = mesh.shape["model"] if split else 1
            if n > h:
                add(_cache_group(name),
                    tree_bytes(sizes[name]) * (n - h) // (n * h))
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def count_program(program: Program):
    """(costs, memory record, counter) of one run of ``program``."""
    with count_costs() as c:
        outputs = program.run()
    return c.costs(), c.memory(program.args, outputs), c


def run_cell(arch, shape_name, *, multi_pod=False, zero1=True, save=True,
             overrides=None, tag=None, microbatches=8,
             grad_compression=None, collective=None, out_dir=None,
             mesh=None):
    """Count one cell and return its record (saved under ``out_dir``,
    default :data:`OUT_DIR`, with ``save``)."""
    t0 = time.time()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, dry=True)
    program, meta = lower_cell(arch, shape_name, multi_pod=multi_pod,
                               zero1=zero1, overrides=overrides,
                               microbatches=microbatches,
                               grad_compression=grad_compression,
                               collective=collective, mesh=mesh)
    if tag:
        meta["tag"] = tag
    meta["overrides"] = dict(overrides or {})
    if program is None:
        print(f"SKIP {arch} × {shape_name}: {meta['skipped']}")
        if save:
            _save(meta, out_dir)
        return meta
    t_lower = time.time() - t0
    t0 = time.time()
    costs, ma, _ = count_program(program)
    t_count = time.time() - t0
    del program
    hw = dataclasses.replace(H100,
                             link_bw=link_bw_for(max(mesh.shape.values())))
    res = analyze(costs, ma, n_chips=meta["n_chips"], kind=meta["kind"],
                  tokens=meta["tokens"], n_params=meta["n_params"],
                  n_active_params=meta["n_active_params"], hw=hw)
    res.update(meta)
    need = ma.argument_size_in_bytes + ma.temp_size_in_bytes
    res["fits"] = bool(need <= hw.hbm_bytes)
    res["hardware"] = {"name": hw.name, "peak_flops": hw.peak_flops,
                       "hbm_bw": hw.hbm_bw, "link_bw": hw.link_bw,
                       "hbm_bytes": hw.hbm_bytes}
    res["t_lower_s"] = round(t_lower, 2)
    res["t_compile_s"] = round(t_count, 2)
    print(f"OK {arch} × {shape_name} × {res['mesh']}: "
          f"flops/chip={res['per_chip']['hlo_flops']:.3e} "
          f"coll={res['per_chip']['collective_bytes']:.3e}B "
          f"dom={res['dominant']} frac={res['roofline_fraction']:.3f} "
          f"args+peak={need / 1e9:.1f}GB fits={res['fits']} "
          f"(build {t_lower:.1f}s count {t_count:.1f}s)")
    if save:
        _save(res, out_dir)
    return res


def _save(res, out_dir=None):
    d = pathlib.Path(out_dir) if out_dir is not None else OUT_DIR
    d.mkdir(parents=True, exist_ok=True)
    tag = f"__{res['tag']}" if res.get("tag") else ""
    name = f"{res['arch']}__{res['shape']}__{res.get('mesh', 'skip')}{tag}.json"
    (d / name).write_text(json.dumps(res, indent=2, default=float))


def _count_one(job):
    """One cell of :func:`run_cells`: None, or the cell and its error."""
    arch, shape, kw = job
    try:
        run_cell(arch, shape, **kw)
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        return arch, shape, repr(e)
    return None


def run_cells(cells, *, jobs: int = 1, **kw) -> list:
    """:func:`run_cell` (``kw``, saving each record) on every (arch,
    shape) of ``cells``, in ``jobs`` processes (spawned: a parent may hold
    a CUDA context) where ``jobs`` > 1, the training cells first, as they
    take longest.  Returns the failures as (arch, shape, error)."""
    order = sorted(cells, key=lambda c: SHAPES[c[1]].kind != "train")
    work = [(a, s, kw) for a, s in order]
    if jobs <= 1:
        results = [_count_one(w) for w in work]
    else:
        with ProcessPoolExecutor(
                jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            results = list(ex.map(_count_one, work))
    return [r for r in results if r is not None]


def main(argv=None):
    """Count ``--arch`` x ``--shape``, or every cell with ``--all``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--collective", choices=("nnz_ar", "nnz_rs"),
                    default=None,
                    help="the MoE's expert-parallel combine (default "
                         "nnz_ar)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="count the cells in this many processes")
    ap.add_argument("--out", default=None,
                    help=f"record directory (default {OUT_DIR})")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in ARCHS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    failures = run_cells(cells, jobs=args.jobs, multi_pod=args.multi_pod,
                         zero1=not args.no_zero1,
                         collective=args.collective, out_dir=args.out)
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
