"""Value-storage dtype names (port of ``repro/core/dtypes.py``).

Only the canonicalisation that ``Schedule`` validates with, plus the
itemsizes the cost model scales by, are ported.  Narrow storage is not
implemented by the port's kernels yet: ``kernels.ops.spmm`` raises
``NotImplementedError`` for any ``value_dtype`` other than float32.
"""
from __future__ import annotations

import numpy as np

#: Valid ``Schedule.value_dtype`` names; ``float32`` normalizes to None.
VALUE_DTYPES = ("float32", "bfloat16", "float16", "float8_e4m3fn", "int8")

_ALIASES = {
    "f32": "float32", "fp32": "float32",
    "bf16": "bfloat16",
    "f16": "float16", "fp16": "float16", "half": "float16",
    "fp8": "float8_e4m3fn", "f8": "float8_e4m3fn",
    "e4m3": "float8_e4m3fn", "float8": "float8_e4m3fn",
}

_VALUE_ITEMSIZE = {None: 4, "bfloat16": 2, "float16": 2,
                   "float8_e4m3fn": 1, "int8": 1}


def canonical_value_dtype(value_dtype):
    """``None`` for float32 (the default) or the canonical name; raises
    ``ValueError`` for anything that is not a supported storage dtype."""
    if value_dtype is None:
        return None
    name = value_dtype if isinstance(value_dtype, str) else None
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


def value_itemsize(value_dtype) -> int:
    """Bytes per stored value under this axis choice."""
    return _VALUE_ITEMSIZE[canonical_value_dtype(value_dtype)]


def operand_itemsize(value_dtype) -> int:
    """Bytes per dense-operand element: int8 values pair with bf16."""
    name = canonical_value_dtype(value_dtype)
    return 2 if name == "int8" else _VALUE_ITEMSIZE[name]
