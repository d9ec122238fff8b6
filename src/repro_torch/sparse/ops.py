"""The public sparse API of the port (port of ``repro/sparse/ops.py``):
schedule resolution, epilogue derivation and kernel dispatch for
``spmm``.

This slice serves the forward only: an input that requires a gradient is
refused rather than answered with an output that has none.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.device import check_on, resolve_device
from ..core.schedule import Epilogue, Schedule, as_schedule
from ..kernels import ops as kops
from .formats import CSR, ELL, GroupedCOO
from .random import matrix_stats

__all__ = ["spmm"]


def _resolve_schedule(a, b, schedule, epilogue: Epilogue | None = None):
    if isinstance(schedule, str) and schedule in ("auto", "tune"):
        if schedule == "tune":
            raise NotImplementedError(
                "schedule='tune' needs the empirical tuner, which the port "
                "does not have yet; use 'auto' or a Schedule")
        if isinstance(a, CSR):
            # memoized: a serving loop derives the statistics once
            stats = a._cached("stats", lambda: matrix_stats(a))
            sched = Schedule.auto(stats, int(b.shape[1]))
        else:
            sched = Schedule("eb")
    else:
        sched = as_schedule(schedule)
    if epilogue is not None:
        sched = sched.replace(epilogue=epilogue)
    return sched


def _derive_epilogue(schedule, epilogue, bias, residual) -> Epilogue | None:
    """Effective epilogue: an explicit ``epilogue=`` wins, else the
    schedule's own; bias/residual flags follow the arrays passed."""
    ep = epilogue
    if ep is None and isinstance(schedule, Schedule):
        ep = schedule.epilogue
    if ep is None:
        ep = Epilogue()
    if bias is not None and not ep.bias:
        ep = dataclasses.replace(ep, bias=True)
    if residual is not None and not ep.residual:
        ep = dataclasses.replace(ep, residual=True)
    return None if ep.is_noop else ep


def spmm(a, b, schedule="auto", *, bias=None, residual=None,
         epilogue: Epilogue | None = None, impl: str = "kernel",
         device=None):
    """out = epilogue(A @ B) for sparse A (CSR / GroupedCOO / ELL) and
    dense B (K, N); the output is (n_rows, N).

    schedule    'auto' | name | Schedule | AtomicParallelism |
                SegmentGroup ('tune' raises until the tuner is ported).
    bias        (N,) fused bias-row add.
    residual    (n_rows, N) fused post-activation residual add.
    epilogue    explicit :class:`~repro_torch.core.Epilogue`; bias and
                residual flags follow the arrays above.
    impl        'kernel' (the scheduled kernel) or 'ref' (plain oracle).
    device      where the operands must lie: None means 'cuda', which
                raises when no CUDA device is available; pass 'cpu' to
                run the kernels' plain versions on the CPU.
    """
    dev = resolve_device(device)
    vals = a.vals if isinstance(a, (CSR, GroupedCOO, ELL)) else None
    check_on(dev, a=vals, b=b, bias=bias, residual=residual)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (vals, b, bias, residual)):
        raise RuntimeError(
            "spmm has no backward in the port yet: an input requires a "
            "gradient, and the output would silently have none.  Run "
            "under torch.no_grad() or detach the inputs.")
    ep = _derive_epilogue(schedule, epilogue, bias, residual)
    sched = _resolve_schedule(a, b, schedule, epilogue=ep)
    return kops.spmm(a, b, sched, bias=bias, residual=residual, impl=impl)
