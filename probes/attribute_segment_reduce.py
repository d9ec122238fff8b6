"""Where the first segment-reduce kernel (an identity fill, then a
thread per (group, column) pair walking its G lanes with 4-byte loads
and an atomic per run) spends its time on the nine cases of
``chip_smoke.py``'s ``segment_profiles`` and on the social hub row alone
(PERF.md section 6, row 4), beside the kernel of
``csrc/segment_reduce.cu`` in the same call.

    PYTHONPATH=src python3 probes/attribute_segment_reduce.py

Builds ``probes/first_segment_reduce.cu`` with the port's nvcc flags and
times, per case: the first kernel as its wrapper ran it (fill and
launch); the launch alone (no fill, into an output left as it was); the
launch alone with every write-back sent to a plain store
(``PLAIN_STORE``: wrong where write-backs meet, for timing only); and
the kernel of this tree through its wrapper, with its kernels one by
one and, as the card's rate on the same bytes, one sum over the data's
rows and one copy of the data.  Each as device time
(``chip_smoke.device_ms``: the kernels' own durations per call, under
the profiler) and as the median of five CUDA-event windows of about 5 ms
of back-to-back calls (host launches included).  Beside them the bytes
bound (ids and data read once, the output written once).  The first
kernel's output with its fill is held to the plain version.  Needs one
GPU.
"""
import ctypes
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

#: Switch of first_segment_reduce.cu.
PLAIN_STORE = 1


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    lib_path = build.BUILD_DIR / "libfirst_segment_reduce.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(ROOT / "probes/first_segment_reduce.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).segred_probe_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    graphs = cs.make_graphs(cs.N_NODES, dev)
    x = torch.randn(cs.N_NODES, cs.N_FEAT,
                    generator=torch.Generator().manual_seed(cs.SEED)).to(dev)
    model = GCN(cs.N_FEAT, cs.HIDDEN, cs.N_CLASS, device=dev,
                generator=torch.Generator().manual_seed(cs.SEED))
    stream = torch.cuda.current_stream().cuda_stream
    checker = cs.Checker(("segment_reduce",))
    with torch.no_grad():
        profiles = cs.segment_profiles(graphs, x, model)
        hub = cs.hub_row(graphs["social"][0], profiles[0][2])
        cases = [(label, seg, data, n_seg, strategy, op)
                 for label, seg, data, n_seg, ops in profiles
                 for strategy, op in ops]
        cases += [("hub row alone", *hub, 1, "segment", op)
                  for op in ("add", "max")]
        total = {}
        for label, seg, data, n_seg, strategy, op in cases:
            t, c = data.shape
            identity = {"add": 0.0, "max": -float("inf"),
                        "min": float("inf")}[op]
            out = torch.full((n_seg, c), identity, device=dev)

            def run(mode, fill):
                if fill:
                    out.fill_(identity)
                err = fn(seg.data_ptr(), data.data_ptr(), out.data_ptr(), t,
                         c, n_seg, 32, sr.CUDA_STRATEGIES[strategy],
                         sr.CUDA_OPS[op], mode, dev.index or 0, stream)
                if err:
                    cs.fail(f"segred_probe_launch: cudaError_t {err}")

            kw = dict(num_segments=n_seg, strategy=strategy, op=op)
            run(0, True)
            checker.record("segment_reduce", f"first kernel {label} "
                           f"{strategy} {op}", out,
                           sr.segment_reduce_plain(seg, data, **kw),
                           exact=op != "add")
            fns = {
                "first: fill and launch": lambda: run(0, True),
                "first: launch alone": lambda: run(0, False),
                "first: plain stores": lambda: run(PLAIN_STORE, False),
                "this tree's kernel": lambda: sr.segment_reduce(seg, data,
                                                                **kw),
            }
            res = {key: (sum(cs.device_ms(f).values()), cs.cuda_ms_median(f))
                   for key, f in fns.items()}
            kernels = cs.device_ms(fns["this tree's kernel"])
            # the card's rate on these bytes: one read of the data
            # (a sum over its rows) and a read and write (a copy)
            rates = {"data.sum(0)": sum(cs.device_ms(
                lambda: data.sum(0)).values()),
                "data.clone()": sum(cs.device_ms(data.clone).values())}
            bound_ms, _ = cs.bound(t * 4 + t * c * 4 + n_seg * c * 4, t * c)
            print(f"segment_reduce {label} {strategy} {op} ({t} x {c} -> "
                  f"{n_seg}; bound {bound_ms:.4f} ms by bytes):",
                  flush=True)
            print("  this tree's kernels: " + ", ".join(
                f"{k[:60]} {v:.4f}" for k, v in kernels.items())
                + "; " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                   rates.items()), flush=True)
            for key, (dev_ms, call_ms) in res.items():
                if label != "hub row alone":
                    got = total.get(key, (0.0, 0.0))
                    total[key] = (got[0] + dev_ms, got[1] + call_ms)
                print(f"  {key:24s} {dev_ms:.4f} ms on the device, call "
                      f"{call_ms:.4f} ms", flush=True)
        checker.done()
    print("segment_reduce, the nine cases summed: " + ", ".join(
        f"{k} {v[0]:.4f} ms on the device (call {v[1]:.4f})"
        for k, v in total.items()), flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
