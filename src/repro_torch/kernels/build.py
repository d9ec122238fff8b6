"""Build and bind the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  Libraries are built at
first use into ``_build/`` beside this file (git-ignored), named by a
hash of their sources and flags, so an edited source is never served by
a stale library.  :func:`build` starts one ``nvcc`` per missing library,
all at once; a source listed in :data:`PARTS` compiles as several objects
at once (``-DKERNEL_PART=k``), linked into its library after.  Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: One library per source.
SOURCES = ("spmm_eb", "spmm_rb", "sddmm", "fused_attention_fwd",
           "fused_attention_bwd", "segment_reduce", "grouped_matmul",
           "eb_partials", "attn_user")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: Sources compiled as this many objects at once, one ``KERNEL_PART``
#: each: ``spmm_eb.cu``'s main kernel has ten instantiations (five
#: (values, B) storage pairs at two vector widths), about 90 s of nvcc
#: in one unit on the H100's host; ``sddmm.cu`` holds one part per type
#: of B (seven (A, B) pairs, each at up to ten geometries);
#: ``grouped_matmul.cu`` splits its routes' operand types four ways.
PARTS = {"spmm_eb": 5, "sddmm": 4, "grouped_matmul": 4}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the port's kernels")
    return found


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>.cu`` is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(str(PARTS.get(source, 1)).encode())
    for p in [CSRC / f"{source}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{source}-{h.hexdigest()[:16]}.so"


def _commands(nvcc: str, source: str, tmp: Path):
    """(compile commands, link command or None) that build
    ``csrc/<source>.cu`` into ``tmp``."""
    src, inc = str(CSRC / f"{source}.cu"), ["-I", str(CSRC)]
    parts = PARTS.get(source, 1)
    if parts == 1:
        return [[nvcc, *NVCC_FLAGS, *inc, "-o", str(tmp), src]], None
    objs = [f"{tmp}.part{k}.o" for k in range(parts)]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    return ([[nvcc, *flags, *inc, "-c", f"-DKERNEL_PART={k}", "-o", o, src]
             for k, o in enumerate(objs)],
            [nvcc, "-shared", "-o", str(tmp), *objs])


def build(sources=SOURCES) -> dict:
    """Compile every library of ``sources`` that is not built yet, one
    ``nvcc`` per source (per part for a source in :data:`PARTS`), all
    started together.  Returns each compiled source's compiler report
    (the seconds into the build by which it was read, its nvcc count,
    then ``-Xptxas -v``: registers, shared memory, spills);
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}  # source -> (compile processes, link command, tmp, lib)
    t0 = time.perf_counter()
    try:
        for s in sources:
            lib = library_path(s)
            if lib.exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            compiles, link = _commands(nvcc, s, tmp)
            jobs[s] = ([subprocess.Popen(c, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
                        for c in compiles], link, tmp, lib)
        reports, failed = {}, []
        for s, (procs, link, tmp, lib) in jobs.items():
            out = "".join(p.communicate()[0] for p in procs)
            code = max(p.returncode for p in procs)
            if not code and link is not None:
                r = subprocess.run(link, capture_output=True, text=True)
                out, code = out + r.stdout + r.stderr, r.returncode
            reports[s] = (f"built {time.perf_counter() - t0:.1f} s into the "
                          f"build ({len(procs)} nvcc)\n{out}")
            if code:
                failed.append(f"--- {s}.cu (exit {code}):\n{out}")
            else:
                os.replace(tmp, lib)
    finally:
        for procs, _, tmp, _ in jobs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for o in BUILD_DIR.glob(f"{tmp.name}.part*.o"):
                o.unlink()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def ptr(t) -> int | None:
    """Device pointer of a tensor for ``ctypes`` (None for None)."""
    return None if t is None else t.data_ptr()


class CudaKernel:
    """One C entry point ``symbol`` of the library built from
    ``csrc/<source>.cu``, launched on PyTorch's current stream.

    ``argtypes`` lists the entry point's arguments without the trailing
    device index and stream.  ``launches`` counts successful launches;
    the wrapper that owns the kernel increments it through
    :meth:`launch` and nowhere else.  ``name`` (the source's by default)
    names it in timings.
    """

    def __init__(self, source: str, symbol: str, argtypes, name=None):
        self.source = source
        self.name = name or source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_int, ctypes.c_void_p]
        self.launches = 0
        self._lib = None
        self._fn = None

    def _load(self):
        if self._fn is None:
            path = library_path(self.source)
            if not path.exists():
                build([self.source])
            self._lib = ctypes.CDLL(str(path))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device`` and its current PyTorch stream; raise if
        the launch was refused (the C function returns
        ``cudaGetLastError()``)."""
        fn = self._load()
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        err = fn(*args, index, torch.cuda.current_stream(index).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} did not launch: cudaError_t {err}")
        self.launches += 1
