"""The segment-reduce kernel's geometry on the cases of ``chip_smoke.py``
(PERF.md section 6, row 4): the chunk size, the boundary between its
lane-parallel and column-parallel walks, and each instantiation's
registers.

    PYTHONPATH=src python3 probes/sweep_segment_reduce.py

Compiles ``csrc/segment_reduce.cu`` as it is and in variants (the lanes
a wide thread holds at once, the wide walk's register budget, the
finishing launch's warps a block; each from a copy of the source with
that text rewritten), printing each kernel's registers and spills, and
times every variant on the nine cases and the hub row alone.  Then,
through the wrapper (the source as it is), each output held to the
plain version (max and min bit for bit, add at ``chip_smoke.F32_TOL``),
each time the device time of a call (``chip_smoke.device_ms``):

- ``TARGET_WARPS`` at 2048, 4096, 8192 and 16384 over the nine cases of
  ``segment_profiles`` and the social hub row alone, with the walk's and
  the finishing launch's shares;
- the social graph's row ids (3.04 M lanes) over C = 1, 2, 4 and 8
  columns of random data under 'segment' add and max, lane-parallel
  (``NARROW_MAX_COLS`` 8) against column-parallel (0).

Needs one GPU.
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import segment_reduce as sr  # noqa: E402
from repro_torch.models import GCN  # noqa: E402

TARGETS = (2048, 4096, 8192, 16384)
WIDTHS = (1, 2, 4, 8)
_COLS = "__launch_bounds__(kWarpsPerBlock * 32)\n    segred_cols("
_WIDE_LANES = "constexpr int kLanes = VEC == 4 ? 2 : 4;"
#: name -> the source's text replacements: the lanes a wide thread holds
#: at once (and as many more in flight), the wide walk's register budget
#: (blocks an SM keeps), and the finishing launch's block size
VARIANTS = {
    "as is": (),
    "wide 1 / 4 lanes": ((_WIDE_LANES,
                          "constexpr int kLanes = VEC == 4 ? 1 : 4;"),),
    "wide 4 / 4 lanes": ((_WIDE_LANES,
                          "constexpr int kLanes = VEC == 4 ? 4 : 4;"),),
    "wide 2 / 8 lanes": ((_WIDE_LANES,
                          "constexpr int kLanes = VEC == 4 ? 2 : 8;"),),
    "wide 4 blocks an SM": ((_COLS, _COLS.replace("32)", "32, 4)")),),
    "finish 8 warps a block": (("constexpr int kFinishWarps = 4;",
                                "constexpr int kFinishWarps = 8;"),),
}


def registers(report):
    """{kernel<template arguments>: (registers, spill bytes)} from nvcc's
    ``-Xptxas -v`` report."""
    out, name = {}, None
    for line in report.splitlines():
        hit = re.search(
            r"entry function '_Z\d+(segred_\w+?)I((?:L[ib]\d+E)+)E", line)
        if hit:
            args = ",".join(re.findall(r"L[ib](\d+)E", hit.group(2)))
            name = f"{hit.group(1)}<{args}>"
        elif "spill" in line and name:
            spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill",
                                                   line))
            out[name] = [None, spill]
        elif "Used" in line and name:
            out.setdefault(name, [None, 0])[0] = int(
                line.split("Used ")[1].split(" ")[0])
            name = None
    return out


def build_variant(name, replacements):
    """The library of ``csrc/segment_reduce.cu`` with ``replacements``
    made, and nvcc's report."""
    src = (build.CSRC / "segment_reduce.cu").read_text()
    for old, new in replacements:
        if old not in src:
            cs.fail(f"variant {name!r}: {old!r} is not in the source")
        src = src.replace(old, new)
    tag = re.sub(r"\W+", "_", name)
    path = build.BUILD_DIR / f"segred_{tag}.cu"
    path.write_text(src)
    lib = build.BUILD_DIR / f"libsegred_{tag}.so"
    report = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(lib), str(path)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if report.returncode:
        cs.fail(f"variant {name!r} did not build:\n{report.stdout}")
    return lib, report.stdout


def use(lib_path):
    """Point the wrapper's walk and finishing launch at ``lib_path``."""
    lib = ctypes.CDLL(str(lib_path))
    for k in (sr.KERNEL, sr.FINISH):
        fn = getattr(lib, k.symbol)
        fn.argtypes = k.argtypes
        fn.restype = ctypes.c_int
        k._lib, k._fn = lib, fn


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, replacements in VARIANTS.items():
        libs[name], report = build_variant(name, replacements)
        print(f"{name}: registers " + ", ".join(
            f"{k} {r} (spill {sp})"
            for k, (r, sp) in sorted(registers(report).items())),
              flush=True)
    graphs = cs.make_graphs(cs.N_NODES, dev)
    x = torch.randn(cs.N_NODES, cs.N_FEAT,
                    generator=torch.Generator().manual_seed(cs.SEED)).to(dev)
    model = GCN(cs.N_FEAT, cs.HIDDEN, cs.N_CLASS, device=dev,
                generator=torch.Generator().manual_seed(cs.SEED))
    checker = cs.Checker(("segment_reduce",))
    with torch.no_grad():
        profiles = cs.segment_profiles(graphs, x, model)
        hub = cs.hub_row(graphs["social"][0], profiles[0][2])
        cases = [(label, seg, data, n_seg, strategy, op)
                 for label, seg, data, n_seg, ops in profiles
                 for strategy, op in ops]
        cases += [("hub row alone", *hub, 1, "segment", op)
                  for op in ("add", "max")]
        wants = [sr.segment_reduce_plain(seg, data, num_segments=n_seg,
                                         strategy=strategy, op=op)
                 for _, seg, data, n_seg, strategy, op in cases]
        for name, lib in libs.items():
            use(lib)
            line = []
            for (label, seg, data, n_seg, strategy, op), want in zip(cases,
                                                                     wants):
                kw = dict(num_segments=n_seg, strategy=strategy, op=op)

                def fn():
                    return sr.segment_reduce(seg, data, **kw)

                checker.record("segment_reduce", f"{name} {label} "
                               f"{strategy} {op}", fn(), want,
                               exact=op != "add")
                line.append(sum(cs.device_ms(fn).values()))
            print(f"variant {name}: the nine cases {sum(line[:9]):.4f} ms; "
                  + ", ".join(f"{v:.4f}" for v in line), flush=True)
        use(libs["as is"])
        default = sr.TARGET_WARPS
        for target in TARGETS:
            sr.TARGET_WARPS = target
            nine = walk = finish = 0.0
            for (label, seg, data, n_seg, strategy, op), want in zip(cases,
                                                                     wants):
                kw = dict(num_segments=n_seg, strategy=strategy, op=op)

                def fn():
                    return sr.segment_reduce(seg, data, **kw)

                checker.record("segment_reduce", f"target {target} {label} "
                               f"{strategy} {op}", fn(), want,
                               exact=op != "add")
                per_kernel = cs.device_ms(fn)
                ms = sum(per_kernel.values())
                fin = sum(v for k, v in per_kernel.items()
                          if "segred_finish" in k)
                chunk = sr.segred_geometry(data.shape[0], data.shape[1], 32,
                                           4 if data.shape[1] % 4 == 0
                                           else 1)[1]
                print(f"TARGET_WARPS {target} {label} {strategy} {op} "
                      f"(chunk {chunk}): {ms:.4f} ms (walk {ms - fin:.4f} "
                      f"+ finish {fin:.4f})", flush=True)
                if label != "hub row alone":
                    nine += ms
                    walk += ms - fin
                    finish += fin
            print(f"TARGET_WARPS {target}: the nine cases {nine:.4f} ms "
                  f"(walk {walk:.4f} + finish {finish:.4f})", flush=True)
        sr.TARGET_WARPS = default
        seg = profiles[0][1]
        gen = torch.Generator().manual_seed(cs.SEED + 9)
        default = sr.NARROW_MAX_COLS
        for c in WIDTHS:
            data = torch.randn(seg.numel(), c, generator=gen).to(dev)
            bound_ms, _ = cs.bound(seg.numel() * (4 + 4 * c)
                                   + cs.N_NODES * c * 4, seg.numel() * c)
            for op in ("add", "max"):
                kw = dict(num_segments=cs.N_NODES, op=op)
                want = sr.segment_reduce_plain(seg, data, **kw)
                res = {}
                for walk_name, narrow in (("lane-parallel", 8),
                                          ("column-parallel", 0)):
                    sr.NARROW_MAX_COLS = narrow
                    checker.record("segment_reduce", f"C={c} {op} "
                                   f"{walk_name}",
                                   sr.segment_reduce(seg, data, **kw), want,
                                   exact=op != "add")
                    res[walk_name] = sum(cs.device_ms(
                        lambda: sr.segment_reduce(seg, data, **kw)).values())
                print(f"row ids x C={c} segment {op} (bound {bound_ms:.4f} "
                      "ms): " + ", ".join(f"{k} {v:.4f} ms"
                                          for k, v in res.items()),
                      flush=True)
                del want
        sr.NARROW_MAX_COLS = default
        checker.done()
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
