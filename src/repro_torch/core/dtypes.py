"""Value-storage dtypes as a scheduling axis (port of ``repro/core/dtypes.py``).

``Schedule.value_dtype`` names one of :data:`VALUE_DTYPES`, and every
layer below resolves it through this module: the kernels load the value
stream and B narrow and convert them to f32 in registers (the conversion
is exact for every type here), so the axis moves storage and traffic
precision, never the precision of the sums.  ``float32`` (or ``None``)
is the identity; ``int8`` selects the quantized value path (per-row
scales, ``sparse.formats.quantize_csr``) with a ``bfloat16`` dense
operand.

``float8_e4m3fn`` degrades to ``bfloat16`` with a :class:`Fp8Fallback`
warning where torch has no fp8 type, where ``REPRO_DISABLE_FP8`` is set,
or on a CUDA device below compute capability 8.9: schedules stay valid
and replayable, only the realized storage width changes.

:func:`cast` is the one cast to a storage type.  For ``float8_e4m3fn``
it gives what the reference's ``astype`` (ml_dtypes) gives: NaN above
464 in magnitude, where torch's own cast saturates to 448.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

#: Valid ``Schedule.value_dtype`` names; ``float32`` normalizes to None.
VALUE_DTYPES = ("float32", "bfloat16", "float16", "float8_e4m3fn", "int8")

_ALIASES = {
    "f32": "float32", "fp32": "float32",
    "bf16": "bfloat16",
    "f16": "float16", "fp16": "float16", "half": "float16",
    "fp8": "float8_e4m3fn", "f8": "float8_e4m3fn",
    "e4m3": "float8_e4m3fn", "float8": "float8_e4m3fn",
}

#: Largest magnitude that rounds to a finite e4m3 value (448) under
#: round-to-nearest-even; anything above it overflows to NaN.
E4M3_OVERFLOW = 464.0


class Fp8Fallback(RuntimeWarning):
    """Warned when fp8 storage degrades to bf16 (missing type, env or
    device)."""


def canonical_value_dtype(value_dtype):
    """``None`` for float32 (the default) or the canonical name; raises
    ``ValueError`` for anything that is not a supported storage dtype.
    fp8 stays canonically valid where it is not supported: resolution
    (and the bf16 fallback) happens in :func:`storage_dtype`."""
    if value_dtype is None:
        return None
    name = value_dtype if isinstance(value_dtype, str) else None
    if name is None and isinstance(value_dtype, torch.dtype):
        name = str(value_dtype).removeprefix("torch.")
    if name is None:
        try:
            name = np.dtype(value_dtype).name
        except TypeError as e:
            raise ValueError(f"invalid value_dtype: {value_dtype!r}") from e
    name = _ALIASES.get(name, name)
    if name not in VALUE_DTYPES:
        raise ValueError(
            f"invalid value_dtype {value_dtype!r}; expected one of "
            f"{VALUE_DTYPES} (or None)")
    return None if name == "float32" else name


def fp8_supported(device=None) -> bool:
    """True when ``float8_e4m3fn`` values can be stored: torch has the
    type, ``REPRO_DISABLE_FP8`` is unset (or ``""``/``"0"``), and a CUDA
    ``device`` has compute capability 8.9 or more (the H100 has 9.0)."""
    if os.environ.get("REPRO_DISABLE_FP8", "") not in ("", "0"):
        return False
    if not hasattr(torch, "float8_e4m3fn"):
        return False
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_capability(device) >= (8, 9)
    return True


def storage_dtype(value_dtype, device=None) -> torch.dtype:
    """The torch storage dtype of a value-dtype name: f32 for ``None``,
    int8 codes for ``"int8"``, and for fp8 ``torch.float8_e4m3fn`` where
    :func:`fp8_supported` holds, else ``torch.bfloat16`` with a
    :class:`Fp8Fallback` warning (never an error)."""
    name = canonical_value_dtype(value_dtype)
    if name is None:
        return torch.float32
    if name == "float8_e4m3fn" and not fp8_supported(device):
        warnings.warn(
            "float8_e4m3fn storage unavailable (no torch.float8_e4m3fn, "
            "REPRO_DISABLE_FP8 set, or a device below compute capability "
            "8.9); degrading value storage to bfloat16",
            Fp8Fallback, stacklevel=2)
        return torch.bfloat16
    return getattr(torch, name)


def operand_dtype(value_dtype, device=None) -> torch.dtype:
    """Storage dtype of the dense operand under this value dtype: narrow
    floats narrow B to the same type, ``int8`` values pair with a
    ``bfloat16`` B; fp8 degrades as in :func:`storage_dtype`."""
    name = canonical_value_dtype(value_dtype)
    if name == "int8":
        return torch.bfloat16
    return storage_dtype(name, device)


def value_itemsize(value_dtype) -> int:
    """Bytes per stored value under this axis choice, after the fp8
    fallback (a degraded fp8 schedule costs 2 bytes)."""
    return storage_dtype(value_dtype).itemsize


def operand_itemsize(value_dtype) -> int:
    """Bytes per dense-operand element under this axis choice."""
    return operand_dtype(value_dtype).itemsize


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype`` as the reference's ``astype`` rounds it: to
    nearest even, and for ``float8_e4m3fn`` NaN where ``|t| > 464``
    (torch saturates there).  Returns ``t`` itself when the dtype
    matches."""
    if t.dtype == dtype:
        return t
    if dtype == getattr(torch, "float8_e4m3fn", None):
        t = t.float()
        t = t.masked_fill(t.abs() > E4M3_OVERFLOW, float("nan"))
    return t.to(dtype)
