"""Registers, spills and stack of every kernel of the port in a given
source tree, as ``nvcc -Xptxas -v`` reports them, so that two commits'
instantiations can be set side by side.

    PYTHONPATH=src python3 probes/ptxas_stats.py [SRC] [SOURCE ...]

SRC is the ``src`` directory of a checkout (by default this one's); its
``repro_torch.kernels.build`` compiles the named sources (all by
default) into a temporary directory, so that nothing built before is
reused, and one line is printed a kernel: the source, its registers,
spill stores and loads and stack frame in bytes, and its demangled name
(``c++filt`` where the toolkit's host has it).  Needs ``nvcc``, no GPU.
"""
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def demangle(names):
    """``names`` demangled by ``c++filt``, or as given without it."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout
    return out.splitlines()


def entries(report):
    """(name, registers, spill stores, spill loads, stack) of each entry
    function in one source's ``-Xptxas -v`` report."""
    rows, name, frame = [], None, (0, 0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, frame = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), frame[1], frame[2],
                         frame[0]))
            name = None
    return rows


def main():
    """Compile and print, as the module docstring says."""
    args = sys.argv[1:]
    src = (Path(args.pop(0)).resolve() if args and Path(args[0]).is_dir()
           else ROOT / "src")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build

    sources = tuple(args) or build.SOURCES
    with tempfile.TemporaryDirectory() as tmp:
        build.BUILD_DIR = Path(tmp)
        reports = build.build(sources)
    print(f"kernels of {src}", flush=True)
    for s in sources:
        rows = entries(reports[s])
        for (_, regs, st, ld, stack), name in zip(
                rows, demangle([r[0] for r in rows])):
            print(f"{s}: {regs} registers, spill {st}/{ld} bytes, stack "
                  f"{stack} bytes: {name}", flush=True)


if __name__ == "__main__":
    main()
