"""Sparse storage formats on torch tensors (port of ``repro/sparse/formats.py``).

COO         (rows, cols, vals) triplets.
CSR         the canonical input format.
GroupedCOO  row-sorted COO padded to a multiple of ``nnz_tile``: the EB
            kernel's feed.  Padded lanes have ``val == 0``.
ELL         per-row padded: the RB kernel's feed.

Index arrays stay int32 on the device, as the kernels take them; torch
index ops convert to int64 where they need it.  The layout passes run in
numpy on the host, line for line as in the reference, so the padded
layouts match the JAX ones index for index.  ``CSR`` and ``GroupedCOO``
memoize their conversions per instance and parameters, so a serving
loop converts once however many requests reuse the matrix.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["COO", "CSR", "GroupedCOO", "ELL", "ELL_MAX_BYTES", "round_up"]

#: Largest ELL layout (index plus value bytes) ``ELL.fromcsr`` allocates.
#: ELL pads every row to the longest one, so a matrix with a hub row
#: would otherwise ask for n_rows x row_max entries.
ELL_MAX_BYTES = 4 << 30


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return ((x + m - 1) // m) * m


def _memoized(obj, key, build):
    """Per-instance conversion memo, kept outside the dataclass fields."""
    cache = obj.__dict__.get("_convcache")
    if cache is None:
        cache = {}
        object.__setattr__(obj, "_convcache", cache)
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _csr_scatter_index(indptr):
    """(row_ids, positions): nnz t of CSR row r lands in ELL slot
    ``t - indptr[r]``."""
    indptr = np.asarray(indptr).astype(np.int64)
    lengths = indptr[1:] - indptr[:-1]
    row_ids = np.repeat(np.arange(lengths.shape[0]), lengths)
    pos = np.arange(indptr[-1]) - np.repeat(indptr[:-1], lengths)
    return row_ids, pos


def _skew_layout(indptr, indices, shape, nnz_tile: int,
                 group_size: int, split_threshold: int | None,
                 merge_threshold: int | None):
    """Host-side two-level layout pass.

    Returns ``(rows, cols, positions, heavy_tiles)`` numpy arrays: the
    first ``heavy_tiles`` nnz tiles hold rows with ``length >=
    split_threshold``, each split across width-``group_size`` groups
    padded with the row's own id; the rest hold the tail in row order,
    with rows of ``length <= merge_threshold`` packed together and longer
    rows aligned to a group boundary (the gap padded with the previous
    row's id, val 0).  ``positions[t]`` is the padded slot of CSR lane t.
    """
    if nnz_tile % group_size:
        raise ValueError(f"nnz_tile {nnz_tile} is not a multiple of "
                         f"group_size {group_size}")
    indptr = np.asarray(indptr).astype(np.int64)
    indices = np.asarray(indices)
    n_rows = shape[0]
    lengths = indptr[1:] - indptr[:-1]
    pad_row = n_rows - 1
    G = group_size
    S = np.iinfo(np.int64).max if split_threshold is None else split_threshold
    M = np.iinfo(np.int64).max if merge_threshold is None else merge_threshold

    heavy = lengths >= S
    h_ids = np.nonzero(heavy)[0]
    h_lens = lengths[h_ids]
    h_pad = -(-h_lens // G) * G
    h_starts = np.concatenate([[0], np.cumsum(h_pad)])[:-1]
    heavy_total = int(h_pad.sum())
    heavy_region = round_up(heavy_total, nnz_tile) if heavy_total else 0

    t_ids = np.nonzero(~heavy & (lengths > 0))[0]
    t_starts = np.empty(len(t_ids), np.int64)
    gaps = []  # (offset, pad lanes, filler row id)
    off = 0
    prev_row = 0
    for i, r in enumerate(t_ids):
        length = int(lengths[r])
        if length > M and off % G:
            pad = G - off % G
            gaps.append((off, pad, prev_row))
            off += pad
        t_starts[i] = off
        off += length
        prev_row = int(r)
    tail_region = round_up(off, nnz_tile) if off else 0

    total = heavy_region + tail_region
    if total == 0:
        total = nnz_tile
    rows = np.full(total, pad_row, np.int32)
    cols = np.zeros(total, np.int32)

    starts = np.zeros(n_rows, np.int64)
    starts[h_ids] = h_starts
    starts[t_ids] = heavy_region + t_starts
    row_ids, pos = _csr_scatter_index(indptr)
    positions = (starts[row_ids] + pos).astype(np.int64)
    rows[positions] = row_ids
    cols[positions] = indices
    spans = h_pad - h_lens
    if spans.sum():
        base = np.repeat(h_starts + h_lens, spans)
        local = np.arange(int(spans.sum())) - np.repeat(
            np.concatenate([[0], np.cumsum(spans)])[:-1], spans)
        rows[base + local] = np.repeat(h_ids, spans)
    for g_off, g_pad, filler in gaps:
        rows[heavy_region + g_off: heavy_region + g_off + g_pad] = filler

    return (rows, cols, positions.astype(np.int32),
            heavy_region // nnz_tile)


def _padded_stream(rows, cols, vals, nnz_tile, pad_row):
    """Standard layout: the triplets followed by trailing padding lanes
    (row ``pad_row``, col 0, val 0) up to a ``nnz_tile`` multiple."""
    nnz = vals.shape[0]
    pad = max(round_up(max(nnz, 1), nnz_tile), nnz_tile) - nnz
    dev = vals.device
    return (torch.cat([rows, torch.full((pad,), pad_row, dtype=torch.int32,
                                        device=dev)]),
            torch.cat([cols, torch.zeros(pad, dtype=torch.int32,
                                         device=dev)]),
            torch.cat([vals, torch.zeros(pad, dtype=vals.dtype, device=dev)]))


@dataclasses.dataclass(frozen=True)
class COO:
    """Unordered triplet format. ``shape`` is the dense (n_rows, n_cols)."""

    rows: torch.Tensor  # (nnz,) int32
    cols: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor  # (nnz,)
    shape: tuple

    @property
    def nnz(self) -> int:
        """Stored-triplet count."""
        return self.vals.shape[0]

    def todense(self) -> torch.Tensor:
        """Scatter-add the triplets into a dense ``shape`` tensor."""
        out = torch.zeros(self.shape, dtype=self.vals.dtype,
                          device=self.vals.device)
        return out.index_put_((self.rows.long(), self.cols.long()),
                              self.vals, accumulate=True)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row, the canonical input format.  Conversions
    (``tocoo``/``grouped``/``ell``) are memoized per instance."""

    indptr: torch.Tensor  # (n_rows + 1,) int32
    indices: torch.Tensor  # (nnz,) int32 column ids
    vals: torch.Tensor  # (nnz,)
    shape: tuple

    @property
    def nnz(self) -> int:
        """Stored-value count."""
        return self.vals.shape[0]

    @property
    def device(self) -> torch.device:
        """Device the arrays lie on."""
        return self.vals.device

    def row_lengths(self) -> torch.Tensor:
        """(n_rows,) per-row nnz counts."""
        return self.indptr[1:] - self.indptr[:-1]

    def _cached(self, key, build):
        return _memoized(self, key, build)

    def tocoo(self) -> COO:
        """Memoized CSR -> COO expansion."""
        def _build():
            rows = torch.repeat_interleave(
                torch.arange(self.shape[0], dtype=torch.int32,
                             device=self.device),
                self.row_lengths().long(), output_size=self.nnz)
            return COO(rows=rows, cols=self.indices, vals=self.vals,
                       shape=self.shape)

        return self._cached("coo", _build)

    def grouped(self, nnz_tile: int, *, group_size: int | None = None,
                split_threshold: int | None = None,
                merge_threshold: int | None = None) -> "GroupedCOO":
        """EB-kernel feed format, memoized per parameter tuple."""
        if split_threshold is None and merge_threshold is None:
            return self._cached(("grouped", nnz_tile),
                                lambda: GroupedCOO.fromcsr(self, nnz_tile))
        key = ("grouped", nnz_tile, group_size, split_threshold,
               merge_threshold)
        return self._cached(
            key, lambda: GroupedCOO.fromcsr(
                self, nnz_tile, group_size=group_size,
                split_threshold=split_threshold,
                merge_threshold=merge_threshold))

    def ell(self, row_tile: int = 8, width: int | None = None) -> "ELL":
        """RB-kernel feed format, memoized per (row_tile, width)."""
        return self._cached(("ell", row_tile, width),
                            lambda: ELL.fromcsr(self, width=width,
                                                row_tile=row_tile))

    def todense(self) -> torch.Tensor:
        """Dense (n_rows, n_cols) tensor of this matrix."""
        return self.tocoo().todense()

    @staticmethod
    def from_numpy(indptr, indices, vals, shape, *, device=None) -> "CSR":
        """CSR from host arrays (for example a JAX ``CSR``'s, through
        ``np.asarray``); indices become int32 and values float32."""
        dev = resolve_device(device)
        shape = tuple(int(s) for s in shape)
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int64)
        vals = np.array(vals, np.float32)  # a copy: never alias the caller's
        # the kernels index B and the output with these unchecked
        if (indptr.shape != (shape[0] + 1,) or indptr[0] != 0
                or np.any(np.diff(indptr) < 0)
                or indptr[-1] != indices.shape[0]
                or indices.shape != vals.shape):
            raise ValueError("malformed CSR: indptr must be non-decreasing "
                             "from 0 to nnz, with n_rows + 1 entries")
        if indices.size and (indices.min() < 0 or indices.max() >= shape[1]):
            raise ValueError(f"column indices outside [0, {shape[1]})")
        return CSR(
            indptr=torch.as_tensor(indptr.astype(np.int32), device=dev),
            indices=torch.as_tensor(indices.astype(np.int32), device=dev),
            vals=torch.as_tensor(vals, device=dev), shape=shape)

    @staticmethod
    def fromdense(mat, *, device=None) -> "CSR":
        """Dense array -> CSR of its nonzeros (host-side numpy pass)."""
        mat = _host(mat)
        rows, cols = np.nonzero(mat)
        counts = np.bincount(rows, minlength=mat.shape[0])
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return CSR.from_numpy(indptr, cols, mat[rows, cols], mat.shape,
                              device=device)


@dataclasses.dataclass(frozen=True)
class GroupedCOO:
    """Row-sorted COO padded to a multiple of ``nnz_tile``: the EB feed.

    ``skew`` is ``None`` for the standard trailing-padded layout, or
    ``(split_threshold, merge_threshold, group_size, heavy_tiles)`` for
    the two-level layout (:func:`_skew_layout`), whose first
    ``heavy_tiles`` tiles hold single-row groups.
    """

    rows: torch.Tensor  # (nnz_padded,) int32, non-decreasing
    cols: torch.Tensor  # (nnz_padded,) int32
    vals: torch.Tensor  # (nnz_padded,)
    shape: tuple
    nnz: int
    nnz_tile: int
    skew: "tuple | None" = None

    @property
    def nnz_padded(self) -> int:
        """Total lane count including padding."""
        return self.vals.shape[0]

    @property
    def num_tiles(self) -> int:
        """Number of nnz tiles."""
        return self.nnz_padded // self.nnz_tile

    @property
    def heavy_tiles(self) -> int:
        """Leading nnz tiles holding split heavy rows (0 if standard)."""
        return self.skew[3] if self.skew is not None else 0

    def skew_positions(self) -> torch.Tensor:
        """(nnz,) int32 padded slot of each original CSR lane (skew only)."""
        pos = self.__dict__.get("_skew_positions")
        if pos is None:
            raise ValueError(
                "this GroupedCOO carries no skew scatter index (standard "
                "layout); rebuild it via CSR.grouped(..., split_threshold=)")
        return pos

    @staticmethod
    def _skew(shape, nnz, nnz_tile, group_size, split_threshold,
              merge_threshold, indptr, indices, vals) -> "GroupedCOO":
        rows, cols, pos, heavy_tiles = _skew_layout(
            indptr, indices, shape, nnz_tile, group_size, split_threshold,
            merge_threshold)
        dev = vals.device
        pos_t = torch.as_tensor(pos, device=dev)
        vpad = torch.zeros(rows.shape[0], dtype=vals.dtype, device=dev)
        vpad[pos_t.long()] = vals
        g = GroupedCOO(
            rows=torch.as_tensor(rows, device=dev),
            cols=torch.as_tensor(cols, device=dev), vals=vpad, shape=shape,
            nnz=nnz, nnz_tile=nnz_tile,
            skew=(split_threshold, merge_threshold, group_size, heavy_tiles))
        object.__setattr__(g, "_skew_positions", pos_t)
        return g

    @staticmethod
    def fromcsr(csr: CSR, nnz_tile: int, *, group_size: int | None = None,
                split_threshold: int | None = None,
                merge_threshold: int | None = None) -> "GroupedCOO":
        """Convert a CSR; thresholds select the two-level skew layout."""
        if split_threshold is None and merge_threshold is None:
            coo = csr.tocoo()
            rows, cols, vals = _padded_stream(coo.rows, coo.cols, coo.vals,
                                              nnz_tile, csr.shape[0] - 1)
            return GroupedCOO(rows=rows, cols=cols, vals=vals,
                              shape=csr.shape, nnz=csr.nnz,
                              nnz_tile=nnz_tile)
        if group_size is None:
            raise ValueError(
                "skew grouping needs the schedule's group_size= (heavy "
                "rows are split at group granularity)")
        return GroupedCOO._skew(csr.shape, csr.nnz, nnz_tile, group_size,
                                split_threshold, merge_threshold,
                                _host(csr.indptr), _host(csr.indices),
                                csr.vals)

    def _compact(self):
        """(rows, cols, vals) in original order without padding."""
        if self.skew is None:
            return (self.rows[: self.nnz], self.cols[: self.nnz],
                    self.vals[: self.nnz])
        pos = self.skew_positions().long()
        return self.rows[pos], self.cols[pos], self.vals[pos]

    def regrouped(self, nnz_tile: int, *, group_size: int | None = None,
                  split_threshold: int | None = None,
                  merge_threshold: int | None = None) -> "GroupedCOO":
        """This GroupedCOO re-laid-out for another tile and/or skew
        partition, memoized per target; a matching target returns
        ``self``."""
        want_skew = (split_threshold is not None
                     or merge_threshold is not None)
        if want_skew and group_size is None:
            raise ValueError(
                "skew regrouping needs the schedule's group_size=")
        if nnz_tile == self.nnz_tile:
            if not want_skew and self.skew is None:
                return self
            if (want_skew and self.skew is not None
                    and self.skew[:3] == (split_threshold, merge_threshold,
                                          group_size)):
                return self

        def _build():
            rows_c, cols_c, vals_c = self._compact()
            if not want_skew:
                rows, cols, vals = _padded_stream(rows_c, cols_c, vals_c,
                                                  nnz_tile,
                                                  self.shape[0] - 1)
                return GroupedCOO(rows=rows, cols=cols, vals=vals,
                                  shape=self.shape, nnz=self.nnz,
                                  nnz_tile=nnz_tile)
            lengths = np.bincount(_host(rows_c), minlength=self.shape[0])
            indptr = np.concatenate([[0], np.cumsum(lengths)])
            return GroupedCOO._skew(self.shape, self.nnz, nnz_tile,
                                    group_size, split_threshold,
                                    merge_threshold, indptr, _host(cols_c),
                                    vals_c)

        return _memoized(self, ("regrouped", nnz_tile, group_size,
                                split_threshold, merge_threshold), _build)

    def todense(self) -> torch.Tensor:
        """Scatter-add the padded triplets (padding adds zero)."""
        return COO(self.rows, self.cols, self.vals, self.shape).todense()


@dataclasses.dataclass(frozen=True)
class ELL:
    """Per-row padded format: the RB feed.  Padding slots point at column
    0 with val 0; the row count is padded to the row tile."""

    cols: torch.Tensor  # (n_rows_padded, width) int32
    vals: torch.Tensor  # (n_rows_padded, width)
    shape: tuple
    width: int

    @property
    def n_rows_padded(self) -> int:
        """Row count padded up to the row tile."""
        return self.vals.shape[0]

    @staticmethod
    def fromcsr(csr: CSR, width: int | None = None, row_tile: int = 8) -> "ELL":
        """CSR -> ELL with rows padded to ``width`` (default: the longest
        row) and the row count to ``row_tile``.  Raises ``ValueError``
        rather than allocate more than :data:`ELL_MAX_BYTES`."""
        indptr = _host(csr.indptr).astype(np.int64)
        n_rows = csr.shape[0]
        lengths = indptr[1:] - indptr[:-1]
        w = int(lengths.max()) if len(lengths) and lengths.max() > 0 else 1
        if width is not None:
            if width < w:
                raise ValueError(f"width {width} < max row length {w}")
            w = width
        w = max(w, 1)
        n_pad = round_up(max(n_rows, 1), row_tile)
        nbytes = n_pad * w * (4 + csr.vals.element_size())
        if nbytes > ELL_MAX_BYTES:
            raise ValueError(
                f"ELL layout of {n_pad} x {w} needs {nbytes} bytes, above "
                f"ELL_MAX_BYTES={ELL_MAX_BYTES}: the longest row sets the "
                "width, so use an 'eb' schedule for this matrix")
        row_ids, pos = _csr_scatter_index(indptr)
        dev = csr.device
        flat = torch.as_tensor(row_ids * w + pos, device=dev)
        ecols = torch.zeros(n_pad * w, dtype=torch.int32, device=dev)
        evals = torch.zeros(n_pad * w, dtype=csr.vals.dtype, device=dev)
        ecols[flat] = csr.indices
        evals[flat] = csr.vals
        return ELL(cols=ecols.reshape(n_pad, w), vals=evals.reshape(n_pad, w),
                   shape=csr.shape, width=w)

    def todense(self) -> torch.Tensor:
        """Dense (n_rows, n_cols) tensor (padding slots add 0)."""
        rows = torch.arange(self.n_rows_padded, dtype=torch.int32,
                            device=self.vals.device).repeat_interleave(
                                self.width)
        full = COO(rows, self.cols.reshape(-1), self.vals.reshape(-1),
                   (self.n_rows_padded, self.shape[1])).todense()
        return full[: self.shape[0]]
