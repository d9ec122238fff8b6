"""Parity of the port's SDDMM (the kernel's plain version on the CPU)
with the JAX package's ``sddmm``, whose Pallas kernel runs in interpret
mode, on the same numpy inputs.

Tolerance: rtol = atol = 1e-5.  Each output is one f32 dot product of
up to 130 terms, summed in another order by XLA and by torch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as js
import repro_torch.sparse as ts
from repro.core import Schedule as JS
from repro.kernels import ops as jops
from repro_torch.core import Schedule as TS
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sddmm as tsddmm

RTOL = ATOL = 1e-5


def _inputs(d, *, sorted_rows=True, seed=0, m=40, n=50):
    """A power-law pattern's (rows, cols) in CSR order, or the same
    lanes shuffled, with dense A (m, d), B (n, d) and a scale."""
    a = ts.power_law_csr(m, n, avg_degree=6.0, alpha=1.6, seed=seed,
                         device="cpu")
    coo = a.tocoo()
    rows, cols = coo.rows.numpy(), coo.cols.numpy()
    rng = np.random.default_rng(seed + 1)
    if not sorted_rows:
        perm = rng.permutation(rows.shape[0])
        rows, cols = rows[perm], cols[perm]
    am = rng.standard_normal((m, d)).astype(np.float32)
    bm = rng.standard_normal((n, d)).astype(np.float32)
    scale = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return rows, cols, am, bm, scale


@pytest.mark.parametrize("d,with_scale,nnz_tile,sorted_rows", [
    (5, False, 32, True), (5, True, 32, False), (130, False, 256, True),
    (130, True, 32, True), (64, True, 64, False)])
def test_sddmm_matches_reference(d, with_scale, nnz_tile, sorted_rows):
    rows, cols, a, b, scale = _inputs(d, sorted_rows=sorted_rows)
    sc = scale if with_scale else None
    want = jops.sddmm(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(a),
                      jnp.asarray(b),
                      None if sc is None else jnp.asarray(sc),
                      nnz_tile=nnz_tile, interpret=True)
    got = tops.sddmm(torch.from_numpy(rows), torch.from_numpy(cols),
                     torch.from_numpy(a), torch.from_numpy(b),
                     None if sc is None else torch.from_numpy(sc),
                     nnz_tile=nnz_tile)
    assert got.dtype == torch.float32 and got.shape == (rows.shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_public_sddmm_matches_reference(impl):
    rows, cols, a, b, scale = _inputs(24, seed=3)
    want = js.sddmm(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(a),
                    jnp.asarray(b), jnp.asarray(scale),
                    schedule=JS(nnz_tile=64),
                    impl="pallas" if impl == "kernel" else "ref")
    got = ts.sddmm(torch.from_numpy(rows), torch.from_numpy(cols),
                   torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(scale), schedule=TS(nnz_tile=64),
                   impl=impl, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_plain_version_chunks_agree_with_oracle(monkeypatch):
    rows, cols, a, b, scale = _inputs(9, seed=5)
    args = [torch.from_numpy(x) for x in (rows, cols, a, b, scale)]
    want = tops.sddmm(*args, impl="ref")
    monkeypatch.setattr(tsddmm, "PLAIN_CHUNK", 50)  # a ragged last chunk
    torch.testing.assert_close(tsddmm.sddmm_plain(*args), want, rtol=0,
                               atol=0)


def test_sddmm_contracts(tmp_path, monkeypatch):
    rows, cols, a, b, _ = _inputs(8)
    r, c, at, bt = (torch.from_numpy(x) for x in (rows, cols, a, b))
    # 'tune' takes the tile tune_segment_reduce picks for the row profile
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_BENCH_ITERS", "1")
    monkeypatch.setenv("REPRO_BENCH_WARMUP", "0")
    got = ts.sddmm(r, c, at, bt, schedule="tune", device="cpu")
    np.testing.assert_allclose(got.numpy(), (a @ b.T)[rows, cols],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(js.sddmm(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(a),
        jnp.asarray(b))), rtol=RTOL, atol=ATOL)
    with pytest.raises(RuntimeError, match="no backward"):
        ts.sddmm(r, c, at.requires_grad_(), bt, device="cpu")
    with pytest.raises(ValueError, match="share D"):
        ts.sddmm(r, c, at.detach(), bt[:, :3], device="cpu")
    empty = torch.zeros(0, dtype=torch.int32)
    assert ts.sddmm(empty, empty, at.detach(), bt,
                    device="cpu").shape == (0,)


@pytest.mark.parametrize("d,aligned,want", [
    (256, True, (4, 32, 1, 2)),   # the hidden width: a warp, 2 vectors a lane
    (40, True, (4, 10, 3, 1)),    # the class width: 3 workers, 2 lanes idle
    (64, True, (4, 16, 2, 1)),
    (128, True, (4, 32, 1, 1)),
    (40, False, (1, 32, 1, 2)),   # misaligned: 4-byte loads
    (37, True, (1, 32, 1, 2)),    # d % 4: 4-byte loads
    (5, True, (1, 5, 6, 1)),
    (1, True, (1, 1, 32, 1)),     # 32 one-lane workers
    (300, True, (4, 32, 1, 4)),   # 75 vectors: 3 a lane, rounded to 4
    (1024, True, (4, 32, 1, 8)),
    (1032, True, (4, 32, 1, 0)),  # past 8 vectors a lane: the wide walk
    (301, True, (1, 32, 1, 0)),
])
def test_sddmm_geometry(d, aligned, want):
    g = tsddmm.sddmm_geometry(d, aligned)
    assert tuple(g) == want
    # the worker's lanes hold the row, and the workers fit the warp
    assert g.vpl == 0 or g.lw * g.vpl * g.vec >= d
    assert g.workers * g.lw <= 32


def test_sddmm_geometry_refuses_empty_rows():
    with pytest.raises(ValueError, match="d must be"):
        tsddmm.sddmm_geometry(0, True)
