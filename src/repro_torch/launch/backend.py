"""Backend setup and the record of what ran (port of
``repro/launch/backend.py``).

``backend_info`` is safe to call any time and is what a bench or a smoke
run prints beside its numbers, so a result says which device (and
whether fp8 storage was native) produced it.  ``setup`` is a launch
script's prologue.

The reference's other helpers steer JAX before it starts, and have no
torch meaning:

- ``set_platform``: JAX picks one platform a process; the port picks a
  device per call (``device=``, default ``cuda``:
  ``core.device.resolve_device``), so there is nothing to pin.
- ``set_host_device_count``: forces XLA's host devices; a mesh of many
  ranks in one process is ``launch.mesh.make_dry_mesh``, and real ranks
  are processes (``torch.distributed``).
- ``pallas_interpret_default``: the port has no interpret mode; a
  kernel's wrapper runs its plain PyTorch version on a CPU tensor and
  the kernel on a CUDA one (``backend_info()["interpret"]`` says which
  this device gets).
"""
from __future__ import annotations

import subprocess

import torch

from ..core.device import resolve_device

__all__ = ["backend_info", "enable_x64", "setup"]


def enable_x64(on: bool = True) -> None:
    """64-bit defaults: ``torch.set_default_dtype(torch.float64)`` (off
    everywhere in this repo, whose kernels' accumulation contract is
    f32; x64 is for oracle checks), or back to f32."""
    torch.set_default_dtype(torch.float64 if on else torch.float32)


def _power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    None where it does not answer."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else None


def backend_info(device=None) -> dict:
    """Snapshot of the backend of ``device`` (None means 'cuda'): the
    reference's keys, ``backend`` ('cuda' or 'cpu'), ``device_kind``
    (the card's name), ``device_count``, ``fp8`` (native e4m3 storage,
    ``core.dtypes.fp8_supported``) and ``interpret`` (True where the
    plain versions run in place of the kernels), and ``power_limit``
    (``nvidia-smi``'s name and power limit, None where it does not
    answer)."""
    from ..core.dtypes import fp8_supported

    dev = resolve_device(device)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        count = torch.cuda.device_count()
    else:
        kind, count = "cpu", 1
    return {
        "backend": dev.type,
        "device_kind": kind,
        "device_count": count,
        "fp8": fp8_supported(dev),
        "interpret": dev.type != "cuda",
        "power_limit": _power_limit() if dev.type == "cuda" else None,
    }


def setup(device=None, *, x64: bool = False) -> dict:
    """One-call launch-script prologue: the precision default, then
    :func:`backend_info` of ``device`` for logging.  On the card it
    keeps f32 products in f32 (TF32 off), as the port's checks do."""
    enable_x64(x64)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return backend_info(dev)
