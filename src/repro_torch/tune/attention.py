"""Fused-sparse-attention schedule tuning (port of
``repro/tune/attention.py``).

The cache key carries the **direction** (``fwd``/``bwd``), the **head
count**, the feature widths and the bias flag beside the row-histogram
fingerprint, as the reference's does: a fwd record never replays for a
bwd query, nor an H=1 record for an H=8 one.

The default objective times the port's attention kernels
(``kernels/fused_attention.py::fused_sparse_attention`` and ``_bwd``) on
the operands' device.  Those kernels take no schedule: they split rows
longer than a chunk whatever the tile, and scatter by column atomics
whatever the strategy.  The reference pool of eight points is kept, so
keys and records compare across the packages, but on the card it is one
program measured eight times and noise picks the winner.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.schedule import Schedule
from ..sparse.formats import _host
from .cache import ScheduleCache, default_cache, fingerprint_from_lengths
from .driver import TuneResult, _replay, drive
from .measure import time_fn
from .space import (SearchContext, SearchSpace, StrategyAxis, TilingAxis,
                    schedule_key)

__all__ = [
    "attention_cache_key",
    "tune_sparse_attention",
]

#: (nnz_tile, group_size, strategy) pool measured per pattern, the
#: reference's: the EB half of the grid minus 'parallel'.
_POOL = [Schedule("eb", nnz_tile=tile, group_size=g, strategy=st)
         for tile in (128, 512)
         for g in (8, 32)
         for st in ("segment", "accumulate")]


def attention_cache_key(rows, n_rows: int, *, n_cols: int, d: int,
                        dv: int, n_heads: int, direction: str,
                        has_bias: bool = False) -> str:
    """Cache key of a fused-attention tuning record: the pattern's
    row-histogram fingerprint (``n_cols``, the key/value count, in its
    shape), the feature widths, the head count, the direction and
    whether a bias rides along."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction must be 'fwd' or 'bwd', "
                         f"got {direction!r}")
    rows_np = _host(rows)
    lengths = np.bincount(rows_np, minlength=max(n_rows, 1))
    fp = fingerprint_from_lengths(lengths, (n_rows, n_cols),
                                  rows_np.shape[0])
    b = "|b" if has_bias else ""
    return f"attn:{fp}|d{d}|dv{dv}|H{n_heads}|{direction}{b}"


def tune_sparse_attention(
    rows,
    cols,
    q,
    k,
    v,
    *,
    n_rows: int,
    bias=None,
    scale: Optional[float] = None,
    direction: str = "fwd",
    cache: Optional[ScheduleCache] = None,
    measure: Optional[Callable[[Schedule], float]] = None,
    warmup: Optional[int] = None,
    iters: Optional[int] = None,
    backend=None,
) -> TuneResult:
    """Empirically pick (nnz_tile, group_size, strategy) for the fused
    sparse-attention kernels over this pattern (``rows`` sorted, CSR
    order).

    ``direction='fwd'`` times ``fused_sparse_attention``; ``'bwd'``
    times the fused backward, running one forward per candidate first
    for the (m, l) row statistics it consumes.  q/k/v may be 2-D (one
    head) or (n, H, ·); the head count is part of the key.  The cache
    defaults to the namespace of q's device.  A hit replays with zero
    measurements."""
    from ..kernels.fused_attention import (
        fused_sparse_attention,
        fused_sparse_attention_bwd,
    )
    from ..sparse.ops import _attn_heads, _sorted_pattern

    qh, kh, vh, _ = _attn_heads(q, k, v)
    n_heads, _, d = qh.shape
    n_cols, dv = vh.shape[1], vh.shape[-1]
    if scale is None:
        scale = float(d) ** -0.5
    key = attention_cache_key(rows, n_rows, n_cols=n_cols, d=d, dv=dv,
                              n_heads=n_heads, direction=direction,
                              has_bias=bias is not None)
    if cache is None:
        cache = default_cache(q.device if backend is None else backend)
    hit = _replay(cache, key)
    if hit is not None:
        return hit

    if measure is None:
        dev = qh.device
        indptr, cols_t = _sorted_pattern(
            torch.as_tensor(rows, device=dev), torch.as_tensor(
                cols, device=dev), n_rows, n_cols)
        # the kernels load q, k and v in their own type
        qh, kh, vh = (t.contiguous() for t in (qh, kh, vh))
        bias_t = (None if bias is None
                  else bias.to(torch.float32).contiguous())
        # the cotangent has the output's shape (H, n_rows, dv)
        gen = torch.Generator(device=dev).manual_seed(0)
        dout = torch.randn((n_heads, n_rows, dv), generator=gen, device=dev)

        def fwd(qq, kk, vv):
            return fused_sparse_attention(indptr, cols_t, qq, kk, vv,
                                          scale=scale, bias=bias_t)

        def measure(s: Schedule) -> float:
            del s  # the kernels take no schedule (module docstring)
            if direction == "fwd":
                return time_fn(lambda qq, kk, vv: fwd(qq, kk, vv)[0],
                               qh, kh, vh, warmup=warmup, iters=iters)
            _, m, l = fwd(qh, kh, vh)

            def bwd(qq, kk, vv, do):
                return fused_sparse_attention_bwd(
                    indptr, cols_t, qq, kk, vv, do, m, l, scale=scale,
                    bias=bias_t)

            return time_fn(bwd, qh, kh, vh, dout, warmup=warmup,
                           iters=iters)

    space = SearchSpace((StrategyAxis(), TilingAxis()), key_fn=schedule_key)
    return drive(space, SearchContext(), cache=cache, key=key,
                 measure=measure, ranked=_POOL)
