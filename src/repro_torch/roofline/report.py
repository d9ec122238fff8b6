"""The dry run's tables from its JSON records (port of
``repro/roofline/report.py``): the roofline terms, the counted detail
and the optimized variants, in the reference's strings, and a table of
its own of what a rank holds against one card's memory (``fits``).

    PYTHONPATH=src python -m repro_torch.roofline.report \
        [--dir experiments/dryrun_torch]

The detail table's "compile s" column holds the seconds the count took
(``t_compile_s``: the port compiles nothing).
"""
from __future__ import annotations

import argparse
import json
import pathlib

ARCH_ORDER = [
    "starcoder2-7b", "deepseek-coder-33b", "yi-34b", "qwen2-7b",
    "paligemma-3b", "mamba2-2.7b", "qwen3-moe-235b-a22b", "dbrx-132b",
    "hymba-1.5b", "whisper-large-v3",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

HINTS = {
    "compute": ("drop replicated attention flops (seq-parallel attention) "
                "or raise arithmetic intensity via larger per-chip tiles"),
    "memory": ("cut HBM traffic: fuse/raise remat granularity, quantize "
               "KV/grads, avoid cache double-buffering"),
    "collective": ("reshard to move bytes off the wire: reduce-scatter "
                   "instead of all-reduce, overlap with compute, compress"),
}


def load(dir_: pathlib.Path) -> dict:
    """The records of ``dir_`` by (arch, shape, mesh, tag)."""
    recs = {}
    for f in sorted(dir_.glob("*.json")):
        r = json.loads(f.read_text())
        key = (r["arch"], r["shape"], r.get("mesh", "skip"),
               r.get("tag") or "")
        recs[key] = r
    return recs


def fmt_si(x, unit=""):
    """``x`` with an SI suffix (K, M, G, T) and two decimals."""
    for div, suf in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(x) >= div:
            return f"{x / div:.2f}{suf}{unit}"
    return f"{x:.2f}{unit}"


def roofline_table(recs, mesh: str) -> str:
    """The baseline roofline terms of every cell on ``mesh``."""
    lines = [
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
        "dominant | model GFLOPs | useful | roofline frac | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, mesh, ""))
            if r is None:
                skip = recs.get((a, s, "skip", ""))
                if skip is not None and mesh == "16x16":
                    lines.append(f"| {a} | {s} | — | — | — | skipped | — | "
                                 f"— | — | {skip['skipped'][:42]}… |")
                continue
            t = r["terms_s"]
            lines.append(
                f"| {a} | {s} | {t['compute'] * 1e3:.1f} | "
                f"{t['memory'] * 1e3:.1f} | {t['collective'] * 1e3:.1f} | "
                f"**{r['dominant']}** | "
                f"{fmt_si(r['model_flops_global'] / 1e9)} | "
                f"{r['useful_flops_ratio']:.2f} | "
                f"{r['roofline_fraction']:.3f} | "
                f"{HINTS[r['dominant']][:52]}… |")
    return "\n".join(lines)


def optimized_table(recs) -> str:
    """Every tagged variant on the single-pod mesh against its base."""
    lines = [
        "| arch | shape | variant | compute (ms) | memory (ms) | "
        "collective (ms) | temp GB | roofline frac (base -> opt) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (a, s, mesh, tag), r in sorted(recs.items()):
        if not tag or mesh != "16x16":
            continue
        base = recs.get((a, s, mesh, ""))
        t = r["terms_s"]
        bf = base["roofline_fraction"] if base else float("nan")
        lines.append(
            f"| {a} | {s} | {tag} | {t['compute'] * 1e3:.1f} | "
            f"{t['memory'] * 1e3:.1f} | {t['collective'] * 1e3:.1f} | "
            f"{(r['per_chip']['temp_bytes'] or 0) / 1e9:.1f} | "
            f"{bf:.3f} -> **{r['roofline_fraction']:.3f}** |")
    return "\n".join(lines)


def dryrun_table(recs, mesh: str) -> str:
    """The counted detail of every cell on ``mesh``."""
    lines = [
        "| arch | shape | HLO GFLOP/chip | HLO GB/chip | coll GB/chip | "
        "top collectives | temp GB | args GB | compile s |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, mesh, ""))
            if r is None:
                continue
            pc = r["per_chip"]
            colls = sorted(r["collectives"].items(),
                           key=lambda kv: -kv[1]["bytes"])[:2]
            cstr = "; ".join(f"{k}×{v['count']}({fmt_si(v['bytes'], 'B')})"
                             for k, v in colls) or "none"
            lines.append(
                f"| {a} | {s} | {pc['hlo_flops'] / 1e9:.0f} | "
                f"{pc['hlo_bytes'] / 1e9:.1f} | "
                f"{pc['collective_bytes'] / 1e9:.2f} | {cstr} | "
                f"{(pc['temp_bytes'] or 0) / 1e9:.1f} | "
                f"{(pc['arg_bytes'] or 0) / 1e9:.1f} | "
                f"{r.get('t_compile_s', 0):.0f} |")
    return "\n".join(lines)


def fits_table(recs, mesh: str) -> str:
    """Per cell: the rank's arguments and counted peak against the card's
    memory, and the unapplied specs that would take most off the
    arguments (``launch.dryrun.unapplied_savings``), largest first."""
    lines = [
        "| arch | shape | args GB | peak GB | total GB | fits | "
        "largest unapplied savings (GB) |",
        "|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s, mesh, ""))
            if r is None:
                continue
            pc = r["per_chip"]
            args_b, peak = pc["arg_bytes"] or 0, pc["temp_bytes"] or 0
            sav = "; ".join(f"{k} {v / 1e9:.1f}"
                            for k, v in list(r.get("savings", {}).items())[:3])
            lines.append(
                f"| {a} | {s} | {args_b / 1e9:.1f} | {peak / 1e9:.1f} | "
                f"{(args_b + peak) / 1e9:.1f} | "
                f"{'yes' if r.get('fits') else '**no**'} | {sav or 'none'} |")
    return "\n".join(lines)


def main(argv=None):
    """Print every table of the records under ``--dir``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    d = (pathlib.Path(args.dir) if args.dir else
         pathlib.Path(__file__).resolve().parents[3] / "experiments" /
         "dryrun_torch")
    recs = load(d)
    for mesh in ("16x16", "2x16x16"):
        n = sum(1 for k in recs if k[2] == mesh and not k[3])
        print(f"\n### Roofline (baseline) — mesh {mesh} ({n} cells)\n")
        print(roofline_table(recs, mesh))
        print(f"\n### Dry-run detail — mesh {mesh}\n")
        print(dryrun_table(recs, mesh))
        print(f"\n### Memory of a rank — mesh {mesh}\n")
        print(fits_table(recs, mesh))
    print("\n### Optimized variants (§Perf, single-pod)\n")
    print(optimized_table(recs))


if __name__ == "__main__":
    main()
