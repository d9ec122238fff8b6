"""Grouped (expert-segment) matmul (port of
``repro/kernels/grouped_matmul.py``): the MoE expert GEMM.  Tokens arrive
sorted by expert and capacity-padded so that each token tile belongs to
one expert; for tile ``i`` with ``e = tile_experts[i]``,
``out[i] = epilogue(x[i] @ weights[e], bias=bias[e])``, summed in f32.

``grouped_matmul`` launches the CUDA kernel of ``csrc/grouped_matmul.cu``
on CUDA tensors and runs ``grouped_matmul_plain`` on CPU tensors.

Source note.  Replaces ``src/repro/kernels/grouped_matmul.py:79
grouped_matmul`` (Pallas body ``_gmm_kernel`` :52, ``pallas_call`` :124).
The TPU kernel scalar-prefetches the tile -> expert map into the weight
BlockSpec and carries its f32 sum over a sequential d-tile grid axis,
with the epilogue on the last step.  On the H100 a block reads its
expert id itself and loops over all of D, so the epilogue runs on the
finished sums in one launch.  On the serving path the tiles hold 4 to
10 rows, so the kernel is bound by the bytes of the expert weights.  x
and the weights are each f32, bf16, fp16 or e4m3, loaded in their own
type and summed in f32, as the reference upcasts inside its kernel.
The pairs that become one 16-bit type exactly (bf16 or fp16 on itself,
a 16-bit x on e4m3 weights, e4m3 on e4m3 through fp16) take route
``"mma"``: tensor-core ``mma.sync`` products, a block per 128-column
slab of a tile holding all of its rows, the weights streamed once per
tile through a ring of ``cp.async`` copies in shared memory (an e4m3
stage converted to 16 bits there).  The other pairs take route
``"fma"``, FMAs on the CUDA cores over operands upcast on load (TF32
would round f32 operands).  :func:`gmm_route` picks the route;
``ROUTE_LAUNCHES`` counts the launches of each.  ``d_tile`` and
``f_tile`` do not change the function, and are checked as the reference
asserts them.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.schedule import Epilogue, torch_dtype
from .build import CudaKernel, ptr
from .common import ACT_CODES, CUDA_FLOAT_DTYPES, CUDA_OUT_DTYPES, DTYPE_CODES

_NOOP = Epilogue()

#: Operand types the CUDA kernel loads (and upcasts to f32), x and the
#: weights each.
CUDA_IN_DTYPES = CUDA_FLOAT_DTYPES

_BF16, _F16, _E4M3 = torch.bfloat16, torch.float16, torch.float8_e4m3fn
#: Beside bf16 on bf16, the (x, weights) pairs the tensor cores take, as
#: one 16-bit type exactly; they copy x 16 bytes at a time.
MMA_NARROW_PAIRS = ((_F16, _F16), (_BF16, _E4M3), (_F16, _E4M3),
                    (_E4M3, _E4M3))

KERNEL = CudaKernel(
    "grouped_matmul", "grouped_matmul_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10)

#: The kernel's routes, by the code its C entry point takes.
ROUTES = {"fma": 0, "mma": 1}

#: Launches of each route (beside ``KERNEL.launches``, which counts all).
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def gmm_route(x_dtype, w_dtype, d: int, f: int, x_addr: int = 0,
              w_addr: int = 0) -> str:
    """The route the CUDA kernel takes: ``"mma"`` (tensor cores) for the
    pairs that become one 16-bit type exactly, where its copies can take
    the rows: bf16 on bf16 with F % 8 == 0, 16-byte aligned weights, D %
    2 == 0 and 4-byte aligned tokens; the :data:`MMA_NARROW_PAIRS` with
    F % 8 == 0 (16 for e4m3 weights), 16-byte aligned weights, and token
    rows of whole 16-byte copies (D a multiple of 16 bytes, tokens
    16-byte aligned).  ``"fma"`` (CUDA cores) for everything else it
    loads."""
    if (x_dtype == w_dtype == _BF16 and f % 8 == 0 and d % 2 == 0
            and w_addr % 16 == 0 and x_addr % 4 == 0):
        return "mma"
    if ((x_dtype, w_dtype) in MMA_NARROW_PAIRS
            and f % (16 if w_dtype == _E4M3 else 8) == 0
            and w_addr % 16 == 0 and (d * x_dtype.itemsize) % 16 == 0
            and x_addr % 16 == 0):
        return "mma"
    return "fma"


def fit_tile(n: int, tile: int) -> int:
    """Largest power-of-two shrink of ``tile`` that divides ``n``: the
    exact blocking of D and F that ``grouped_matmul`` checks."""
    t = max(1, min(tile, n))
    while n % t and t > 1:
        t //= 2
    return t


def _check(x, tile_experts, weights, bias, epilogue, token_tile, f_tile,
           d_tile):
    """Raise ValueError for what the reference asserts."""
    if x.dim() != 2 or weights.dim() != 3:
        raise ValueError(f"need x (T_pad, D) and weights (E, D, F), got "
                         f"{tuple(x.shape)} and {tuple(weights.shape)}")
    t_pad, d = x.shape
    e, dw, f = weights.shape
    if dw != d or token_tile < 1 or t_pad % token_tile:
        raise ValueError(f"x {tuple(x.shape)} against weights "
                         f"{tuple(weights.shape)}: need D equal and T_pad a "
                         f"multiple of token_tile={token_tile}")
    if tuple(tile_experts.shape) != (t_pad // token_tile,):
        raise ValueError(f"tile_experts {tuple(tile_experts.shape)}: need "
                         f"one expert per token tile, "
                         f"({t_pad // token_tile},)")
    if d_tile < 1 or f_tile < 1 or d % d_tile or f % f_tile:
        raise ValueError(f"d_tile={d_tile} and f_tile={f_tile} must divide "
                         f"D={d} and F={f}")
    if epilogue.residual:
        raise ValueError("grouped_matmul has no residual operand (there is "
                         "no (T_pad, F) residual in the expert-sorted layout)")
    if epilogue.bias != (bias is not None):
        raise ValueError("pass bias exactly when the epilogue declares it")
    if bias is not None and tuple(bias.shape) != (e, f):
        raise ValueError(f"bias {tuple(bias.shape)}, need per-expert "
                         f"{(e, f)}")


def grouped_matmul_plain(x, tile_experts, weights, *, bias=None,
                         epilogue: Epilogue = _NOOP, token_tile: int = 128):
    """Plain version of the kernel, as the reference's
    ``grouped_matmul_ref`` computes it: every tile's expert block gathered
    and upcast to f32, one batched product, the epilogue spec on the f32
    sums.  Runs on any device; it materializes ``weights[tile_experts]``
    in f32, so it is a check, never the serving path."""
    t_pad, d = x.shape
    xt = x.reshape(-1, token_tile, d).to(torch.float32)
    te = tile_experts.long()
    z = torch.bmm(xt, weights[te].to(torch.float32))  # (NT, tt, F)
    b = None if bias is None else bias[te][:, None, :].to(torch.float32)
    return epilogue.apply(z, bias=b).reshape(t_pad, -1)


def grouped_matmul(x, tile_experts, weights, *, bias=None,
                   epilogue: Epilogue = _NOOP, token_tile: int = 128,
                   f_tile: int = 128, d_tile: int = 128):
    """x (T_pad, D) expert-sorted tokens, T_pad % token_tile == 0;
    tile_experts (T_pad // token_tile,) int expert of each tile; weights
    (E, D, F); bias (E, F) per expert, given exactly when
    ``epilogue.bias``.  Returns (T_pad, F) in ``epilogue.out_dtype`` (f32
    by default) with the epilogue applied to the f32 sums.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the route :func:`gmm_route` picks, or raise for what it does not take
    (operands other than f32, bf16, fp16 and float8_e4m3fn, an output
    type other than those of ``CUDA_OUT_DTYPES``: the same four).
    """
    _check(x, tile_experts, weights, bias, epilogue, token_tile, f_tile,
           d_tile)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, tile_experts, weights, bias=bias,
                                    epilogue=epilogue, token_tile=token_tile)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped-matmul kernel for device {x.device}")
    for name, t in (("tile_experts", tile_experts), ("weights", weights),
                    ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("weights", weights)):
        if t.dtype not in CUDA_IN_DTYPES:
            raise NotImplementedError(
                f"{name} is {t.dtype}; the CUDA kernel loads "
                f"{CUDA_IN_DTYPES}")
    out_dtype = torch_dtype(epilogue.out_dtype or "float32")
    if out_dtype not in CUDA_OUT_DTYPES:
        raise NotImplementedError(
            f"the CUDA epilogue stores {CUDA_OUT_DTYPES}, not {out_dtype}")
    xc = x.contiguous()
    wc = weights.contiguous()
    te = tile_experts.to(torch.int32).contiguous()
    bias_c = (None if bias is None
              else bias.to(torch.float32).contiguous())
    e, d, f = wc.shape
    route = gmm_route(xc.dtype, wc.dtype, d, f, xc.data_ptr(), wc.data_ptr())
    out = torch.empty((x.shape[0], f), dtype=out_dtype, device=x.device)
    KERNEL.launch(x.device, ptr(xc), ptr(te), ptr(wc), ptr(bias_c), ptr(out),
                  te.numel(), token_tile, e, d, f, DTYPE_CODES[xc.dtype],
                  DTYPE_CODES[wc.dtype], ACT_CODES[epilogue.activation],
                  DTYPE_CODES[out_dtype], ROUTES[route])
    ROUTE_LAUNCHES[route] += 1
    return out
