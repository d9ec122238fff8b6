"""The grouped matmul's weight and bias gradients: for every expert ``e``,
``dW[e] = sum_{i: te[i] = e} x[i]^T dz[i]`` and ``db[e] = sum_{i: te[i] =
e}`` of the rows of ``dz[i]``, summed in f32, ``dW`` stored in the
weights' type and ``db`` in the bias's.

``grouped_matmul_dw`` launches the CUDA kernel of
``csrc/grouped_matmul_dw.cu`` on CUDA tensors and runs
``grouped_matmul_dw_plain`` on CPU tensors.

Source note.  Replaces the backward of ``src/repro/kernels/grouped_
matmul.py:79 grouped_matmul`` (``pallas_call`` :124) as
``src/repro/kernels/ops.py:318-324`` writes it in pure JAX: every tile's
``(D, F)`` product in f32, scatter-added over the expert axis by
``tile_experts``.  This is the paper's segment reduction with the expert
as the segment: :func:`tile_csr` lists each expert's tiles once (offsets
and order, a CSR of tiles) and a block of the kernel owns one (expert, D
slab, F slab), walks that expert's tiles and writes once, with no atomics
and no ``(NT, D, F)`` temporary.  Any tile map is taken: unsorted, with
experts that own no tile (their gradient is 0), and with ids outside
``[0, E)``, whose tiles add to no expert, as the reference's scatter
drops them.

The route is fixed by the tokens' type before the launch
(``grouped_matmul.gmm_bwd_route``): ``"mma"`` for bf16 and e4m3 tokens,
whose values are exactly bf16, with dz split into three bf16 parts
(``grouped_matmul.split_bf16x3``) whose products the tensor cores sum
exactly; ``"fma"``, f32 FMAs on the CUDA cores, for f32 and fp16 tokens.
``ROUTE_LAUNCHES`` counts the launches of each.
"""
from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel, ptr
from .common import CUDA_FLOAT_DTYPES, DTYPE_CODES
from .grouped_matmul import gmm_bwd_route

KERNEL = CudaKernel("grouped_matmul_dw", "grouped_matmul_dw_launch",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6)

#: Launches of each route (``grouped_matmul.ROUTES``' names).
ROUTE_LAUNCHES = {"fma": 0, "mma": 0}


def tile_csr(tile_experts, n_experts: int):
    """(offsets (E + 1,), order) int32 on the map's device: the tiles of
    expert ``e`` are ``order[offsets[e]:offsets[e + 1]]``, in increasing
    index; tiles whose id lies outside ``[0, E)`` are listed under none."""
    te = tile_experts.long()
    valid = (te >= 0) & (te < n_experts)
    key = torch.where(valid, te, torch.full_like(te, n_experts))
    order = torch.sort(key, stable=True).indices[: int(valid.sum())]
    counts = torch.bincount(te[valid], minlength=n_experts)
    offsets = torch.zeros(n_experts + 1, dtype=torch.int64, device=te.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets.to(torch.int32), order.to(torch.int32)


def _check(x, dz, tile_experts, n_experts, token_tile):
    if x.dim() != 2 or dz.dim() != 2 or x.shape[0] != dz.shape[0]:
        raise ValueError(f"need x (T_pad, D) and dz (T_pad, F), got "
                         f"{tuple(x.shape)} and {tuple(dz.shape)}")
    if token_tile < 1 or x.shape[0] % token_tile or tuple(
            tile_experts.shape) != (x.shape[0] // token_tile,):
        raise ValueError(f"tile_experts {tuple(tile_experts.shape)}: need "
                         f"one expert per token tile of {token_tile} rows "
                         f"of {x.shape[0]}")
    if n_experts < 0:
        raise ValueError(f"n_experts={n_experts}")


def grouped_matmul_dw_plain(x, dz, tile_experts, n_experts: int, *,
                            token_tile: int, w_dtype, bias_dtype=None):
    """Plain version: x and dz upcast to f32; for each expert, its tiles'
    rows gathered in tile order and one product ``x_e^T dz_e`` (and
    ``dz_e``'s column sums when ``bias_dtype`` is given).  Returns ``(dW
    (E, D, F) in w_dtype, db (E, F) in bias_dtype or None)``."""
    _check(x, dz, tile_experts, n_experts, token_tile)
    d, f = x.shape[1], dz.shape[1]
    offsets, order = tile_csr(tile_experts, n_experts)
    offsets = offsets.tolist()
    rows = (order.long()[:, None] * token_tile + torch.arange(
        token_tile, device=x.device)).reshape(-1)
    dw = torch.zeros((n_experts, d, f), dtype=torch.float32, device=x.device)
    db = (None if bias_dtype is None else torch.zeros(
        (n_experts, f), dtype=torch.float32, device=x.device))
    xf, zf = x.to(torch.float32), dz.to(torch.float32)
    for e in range(n_experts):
        r = rows[offsets[e] * token_tile: offsets[e + 1] * token_tile]
        if r.numel() == 0:
            continue
        ze = zf[r]
        dw[e] = xf[r].t() @ ze
        if db is not None:
            db[e] = ze.sum(dim=0)
    return dw.to(w_dtype), None if db is None else db.to(bias_dtype)


def grouped_matmul_dw(x, dz, tile_experts, n_experts: int, *,
                      token_tile: int, w_dtype, bias_dtype=None):
    """x (T_pad, D) expert-sorted tokens, dz (T_pad, F) the gradient of
    the pre-activation, tile_experts (T_pad // token_tile,) the expert of
    each tile.  Returns ``(dW (E, D, F) in w_dtype, db (E, F) in
    bias_dtype, or None when bias_dtype is None)``.

    CPU tensors run the plain version; CUDA tensors launch the kernel (x
    f32, bf16, fp16 or float8_e4m3fn; dz taken as f32; dW stored in any of
    those four) on the route ``gmm_bwd_route`` picks by x's type, or
    raise for what it does not take."""
    _check(x, dz, tile_experts, n_experts, token_tile)
    if x.device.type == "cpu":
        return grouped_matmul_dw_plain(x, dz, tile_experts, n_experts,
                                       token_tile=token_tile, w_dtype=w_dtype,
                                       bias_dtype=bias_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped-matmul gradient kernel for device "
                         f"{x.device}")
    for name, t in (("dz", dz), ("tile_experts", tile_experts)):
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    for name, dt in (("x", x.dtype), ("w_dtype", w_dtype)):
        if dt not in CUDA_FLOAT_DTYPES:
            raise NotImplementedError(
                f"{name} is {dt}; the CUDA kernel takes {CUDA_FLOAT_DTYPES}")
    xc = x.contiguous()
    zc = dz.to(torch.float32).contiguous()
    offsets, order = tile_csr(tile_experts, n_experts)
    d, f = x.shape[1], dz.shape[1]
    dw = torch.empty((n_experts, d, f), dtype=w_dtype, device=x.device)
    db = (None if bias_dtype is None else torch.empty(
        (n_experts, f), dtype=torch.float32, device=x.device))
    route = gmm_bwd_route(xc.dtype, d, f, xc.data_ptr(), zc.data_ptr())
    KERNEL.launch(x.device, ptr(xc), ptr(zc), ptr(offsets), ptr(order),
                  ptr(dw), ptr(db), n_experts, d, f, token_tile,
                  DTYPE_CODES[xc.dtype], DTYPE_CODES[w_dtype])
    ROUTE_LAUNCHES[route] += 1
    return dw, None if db is None else db.to(bias_dtype)
