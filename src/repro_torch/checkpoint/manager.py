"""Checkpointing with an integrity manifest, atomic commit, async save
and retention (port of ``repro/checkpoint/manager.py``).

Layout (one directory per step):

    <dir>/step_00000100.tmp/...   (written)
    <dir>/step_00000100/          (atomic rename on commit)
        manifest.json             {leaf path -> file, shape, dtype, crc32}
        arr_00000.npy ...

Leaves are keyed by their path in the port's tree (``core.tree``; e.g.
``params/layers/0/attn/wq/w``).  Each is copied to the host at save time
and written as .npy with a crc32 of its bytes in the manifest; types
numpy lacks (bfloat16, float8_e4m3fn) are stored as their bits in an
integer type of the same width, with the type's name in the manifest.
Restore verifies the checksums and places each leaf on the device of the
tree it restores into.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import pathlib
import shutil
import zlib

import numpy as np
import torch

from ..core.tree import key_str, tree_leaves_with_path, tree_unflatten

#: Types numpy cannot hold, by name: stored as the bits of an integer
#: type of their width.
_BIT_TYPES = {"bfloat16": (torch.bfloat16, torch.int16),
              "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8)}


def _to_host(t) -> tuple:
    """(numpy array, type name) of a leaf."""
    t = torch.as_tensor(t).detach().to("cpu").contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if name in _BIT_TYPES:
        t = t.view(_BIT_TYPES[name][1])
    return t.numpy(), name


def _from_host(arr, name):
    t = torch.from_numpy(arr)
    return t.view(_BIT_TYPES[name][0]) if name in _BIT_TYPES else t


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = (cf.ThreadPoolExecutor(max_workers=1) if async_save
                      else None)
        self._pending: cf.Future | None = None

    # ------------------------------------------------------------ save

    def save(self, step: int, tree) -> None:
        """Copy to the host now, write to disk in the background (one save
        in flight at a time), commit atomically."""
        host = [(p, *_to_host(v)) for p, v in tree_leaves_with_path(tree)]
        if self._pending is not None:
            self._pending.result()
        if self._pool is not None:
            self._pending = self._pool.submit(self._write, step, host)
        else:
            self._write(step, host)

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, host_leaves) -> None:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (path, arr, name) in enumerate(host_leaves):
            fname = f"arr_{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append({
                "key": key_str(path),
                "file": fname,
                "shape": list(arr.shape),
                "dtype": name,
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------- restore

    def all_steps(self):
        return sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if not p.name.endswith(".tmp") and (p / "manifest.json").exists())

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None):
        """A tree shaped as ``tree_like`` with the leaves of checkpoint
        ``step`` (the latest by default), each on the device of the leaf
        it replaces; raises IOError on a checksum mismatch.  Returns
        ``(tree, step)``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_key = {rec["key"]: rec for rec in manifest["leaves"]}
        out = []
        for path, like in tree_leaves_with_path(tree_like):
            rec = by_key[key_str(path)]
            arr = np.load(d / rec["file"])
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != rec["crc32"]:
                raise IOError(
                    f"checksum mismatch for {rec['key']} in step {step}")
            t = _from_host(arr, rec["dtype"])
            out.append(t.to(like.device) if isinstance(like, torch.Tensor)
                       else t)
        return tree_unflatten(tree_like, out), step
