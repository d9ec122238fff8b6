"""Parity of the port's ``spmm`` (EB and RB kernels' plain versions on
the CPU) with the JAX reference's ``spmm``, whose Pallas kernels run in
interpret mode, and the §3.1 rejection checked against the dense oracle.

Tolerances: f32 outputs compare at rtol = atol = 1e-5.  bf16 outputs
compare at rtol = atol = 2^-7 (one bf16 step): both packages round an
f32 result whose last bits differ with the order of the sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as js
import repro_torch.sparse as ts
from repro.core import Epilogue as JE
from repro.core import Schedule as JS
from repro_torch.core import Epilogue as TE
from repro_torch.core import Schedule as TS
from repro_torch.core import register_strategy, spec_accumulate
from repro_torch.core.dtypes import cast, operand_dtype, storage_dtype
from repro_torch.kernels import spmm_eb as teb

RTOL = ATOL = 1e-5
BF16_TOL = 2.0 ** -7
N_DENSE = 12

EPILOGUES = {
    "none": ({}, False, False),
    "bias+relu": (dict(activation="relu"), True, False),
    "bias+gelu+residual": (dict(activation="gelu"), True, True),
    "bf16": (dict(out_dtype="bfloat16"), False, False),
}


def _inputs(n=96, seed=0):
    a_j = js.power_law_csr(n, n, avg_degree=5.0, alpha=1.6, seed=seed)
    a_t = ts.power_law_csr(n, n, avg_degree=5.0, alpha=1.6, seed=seed,
                           device="cpu")
    rng = np.random.default_rng(seed + 100)
    b = rng.standard_normal((n, N_DENSE)).astype(np.float32)
    bias = rng.standard_normal(N_DENSE).astype(np.float32)
    res = rng.standard_normal((n, N_DENSE)).astype(np.float32)
    return a_j, a_t, b, bias, res


def _run_both(sched_kw, ep_name, *, skew=None, named=None):
    a_j, a_t, b, bias, res = _inputs()
    ep_kw, use_bias, use_res = EPILOGUES[ep_name]
    if named is not None:
        s_j, s_t = JS.named(named, **sched_kw), TS.named(named, **sched_kw)
    else:
        s_j, s_t = JS(**sched_kw), TS(**sched_kw)
    out_j = js.spmm(a_j, jnp.asarray(b), schedule=s_j,
                    bias=jnp.asarray(bias) if use_bias else None,
                    residual=jnp.asarray(res) if use_res else None,
                    epilogue=JE(**ep_kw), interpret=True)
    out_t = ts.spmm(a_t, torch.from_numpy(b), schedule=s_t,
                    bias=torch.from_numpy(bias) if use_bias else None,
                    residual=torch.from_numpy(res) if use_res else None,
                    epilogue=TE(**ep_kw), device="cpu")
    if ep_kw.get("out_dtype") == "bfloat16":
        assert out_t.dtype == torch.bfloat16
        tol = BF16_TOL
    else:
        assert out_t.dtype == torch.float32
        tol = RTOL
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("ep", sorted(EPILOGUES))
@pytest.mark.parametrize("G", [8, 32])
@pytest.mark.parametrize("strategy", ["segment", "accumulate"])
def test_eb_matches_reference(strategy, G, ep):
    _run_both(dict(kernel="eb", nnz_tile=64, col_tile=8, group_size=G,
                   strategy=strategy), ep)


@pytest.mark.parametrize("split,merge,strategy", [
    (8, 2, "segment"), (8, 0, "parallel"), (4, None, "accumulate"),
    (16, 0, "segment")])
@pytest.mark.parametrize("ep", ["none", "bias+gelu+residual"])
def test_eb_skew_heavy_tiles_match_reference(split, merge, strategy, ep):
    _, a_t, _, _, _ = _inputs()
    g = a_t.grouped(32, group_size=8, split_threshold=split,
                    merge_threshold=merge)
    assert g.heavy_tiles > 0
    _run_both(dict(kernel="eb", nnz_tile=32, col_tile=8, group_size=8,
                   strategy=strategy, split_threshold=split,
                   merge_threshold=merge), ep)


@pytest.mark.parametrize("ep", sorted(EPILOGUES))
@pytest.mark.parametrize("row_tile", [4, 8])
def test_rb_matches_reference(row_tile, ep):
    _run_both(dict(base_row_tile=row_tile), ep, named="RB+PR")


@pytest.mark.parametrize("ep", ["none", "bias+relu"])
def test_auto_schedule_matches_reference(ep):
    a_j, a_t, b, bias, _ = _inputs(n=128, seed=4)
    use_bias = EPILOGUES[ep][1]
    out_j = js.spmm(a_j, jnp.asarray(b), schedule="auto",
                    bias=jnp.asarray(bias) if use_bias else None)
    out_t = ts.spmm(a_t, torch.from_numpy(b), schedule="auto",
                    bias=torch.from_numpy(bias) if use_bias else None,
                    device="cpu")
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("fmt", ["csr", "grouped", "ell"])
def test_ref_impl_matches_reference(fmt):
    a_j, a_t, b, bias, _ = _inputs(seed=2)
    if fmt == "grouped":
        a_j, a_t = a_j.grouped(64), a_t.grouped(64)
    elif fmt == "ell":
        a_j, a_t = a_j.ell(8), a_t.ell(8)
    out_j = js.spmm(a_j, jnp.asarray(b), schedule=JS(), impl="ref",
                    bias=jnp.asarray(bias), epilogue=JE("tanh"))
    out_t = ts.spmm(a_t, torch.from_numpy(b), schedule=TS(), impl="ref",
                    bias=torch.from_numpy(bias), epilogue=TE("tanh"),
                    device="cpu")
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL,
                               atol=ATOL)


# --- ROADMAP §3.1: 'parallel' where a group spans rows -------------------


@pytest.mark.parametrize("split,merge", [(None, None), (8, None), (8, 1),
                                         (8, 2), (8, 0)])
def test_parallel_layouts_against_dense_oracle(split, merge):
    """Each layout's 'parallel' result, run through the EB kernel's plain
    version with no Schedule in the way, against the dense product: the
    layouts the port's Schedule rejects give wrong sums, the one it
    accepts (merge_threshold=0) gives the right one."""
    a_t = ts.power_law_csr(48, 48, avg_degree=6.0, alpha=1.6, seed=0,
                           device="cpu")
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (48, 5)).astype(np.float32))
    want = a_t.todense() @ b
    if split is None and merge is None:
        g = a_t.grouped(32)
    else:
        g = a_t.grouped(32, group_size=8, split_threshold=split,
                        merge_threshold=merge)
    got = teb.spmm_eb(g.rows, g.cols, g.vals, b, n_rows=48, nnz_tile=32,
                      group_size=8, strategy="parallel",
                      heavy_tiles=g.heavy_tiles)
    legal = merge == 0
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4) == legal
    kw = dict(kernel="eb", nnz_tile=32, group_size=8, strategy="parallel",
              split_threshold=split, merge_threshold=merge)
    if legal:
        out = ts.spmm(a_t, b, schedule=TS(**kw), device="cpu")
        torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    else:
        with pytest.raises(ValueError, match="merge_threshold=0"):
            TS(**kw)


# --- the port's own contracts --------------------------------------------


def test_spmm_refuses_inputs_that_require_grad():
    """Over a CSR, spmm is differentiable and matches autograd through
    the dense product; a GroupedCOO or ELL input that requires a
    gradient is still refused (its kernel output would have none)."""
    _, a_t, b, _, _ = _inputs()
    bt = torch.from_numpy(b).requires_grad_()
    a_t.vals.requires_grad_()
    cot = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (96, N_DENSE)).astype(np.float32))
    out = ts.spmm(a_t, bt, device="cpu")
    dvals, db = torch.autograd.grad(out, (a_t.vals, bt), cot)
    dense = a_t.todense().detach().requires_grad_()
    ddense, db_want = torch.autograd.grad(dense @ bt, (dense, bt), cot)
    coo = a_t.tocoo()
    torch.testing.assert_close(db, db_want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(dvals, ddense[coo.rows.long(),
                                             coo.cols.long()],
                               rtol=RTOL, atol=ATOL)
    for fmt, sched in ((a_t.grouped(64), TS(nnz_tile=64)),
                       (a_t.ell(8), TS(kernel="rb"))):
        with pytest.raises(RuntimeError, match="no backward"):
            ts.spmm(fmt, bt, sched, device="cpu")
        with torch.no_grad():
            assert ts.spmm(fmt, bt, sched, device="cpu").shape == (
                96, N_DENSE)


def test_narrow_value_dtype_is_not_ported():
    """Narrow value storage, refused until the low-precision slice, now
    runs: bf16 storage on the power-law matrix equals the JAX package's
    (tests/test_torch_lowprec.py holds every dtype and schedule)."""
    a_j, a_t, b, _, _ = _inputs()
    out_t = ts.spmm(a_t, torch.from_numpy(b),
                    schedule=TS(value_dtype="bf16"), device="cpu")
    out_j = js.spmm(a_j, jnp.asarray(b), schedule=JS(value_dtype="bf16"),
                    interpret=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)


def _tuner_env(tmp_path, monkeypatch):
    """A tmp tuner cache and one timed call a measured point."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_BENCH_ITERS", "1")
    monkeypatch.setenv("REPRO_BENCH_WARMUP", "0")


def test_schedule_tune_matches_jax_and_the_dense_oracle(tmp_path,
                                                        monkeypatch):
    """'tune' measures the candidates (the plain versions on the CPU),
    persists the winner in the port's own file, and replays it; the
    output equals the dense oracle and the JAX package's on the tuned
    schedule."""
    import dataclasses

    from repro_torch.tune import default_cache_path, tune_schedule

    _tuner_env(tmp_path, monkeypatch)
    a_j, a_t, b, bias, _ = _inputs()
    bt, biast = torch.from_numpy(b), torch.from_numpy(bias)
    got = ts.spmm(a_t, bt, schedule="tune", bias=biast,
                  epilogue=TE("relu"), device="cpu")
    res = tune_schedule(a_t, N_DENSE, epilogue=TE("relu", bias=True),
                        measure=lambda s: 1 / 0)
    assert res.from_cache and res.schedule.epilogue == TE("relu", bias=True)
    assert default_cache_path().name == "tune.torch-cpu.json"
    assert default_cache_path().exists()
    # the dense oracle on the values and B the pick stores (the tuner's
    # dtype axis may narrow them), in f32
    vd = res.schedule.value_dtype
    stored = (a_t.quantized().dequantize().vals if vd == "int8" else
              a_t.astype(storage_dtype(vd)).vals.float())
    dense = ts.CSR(a_t.indptr, a_t.indices, stored, a_t.shape).todense()
    b_stored = cast(bt, operand_dtype(vd)).float()
    torch.testing.assert_close(got, torch.relu(dense @ b_stored + biast),
                               rtol=RTOL, atol=ATOL)
    want = js.spmm(a_j, jnp.asarray(b), bias=jnp.asarray(bias),
                   epilogue=JE("relu"),
                   schedule=JS(**dataclasses.asdict(res.schedule)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    again = ts.spmm(a_t, bt, schedule="tune", bias=biast,
                    epilogue=TE("relu"), device="cpu")
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_user_strategy_runs_through_its_spec_on_cpu():
    register_strategy("t_spmm_user_acc", spec_accumulate, overwrite=True)
    _, a_t, b, _, _ = _inputs()
    bt = torch.from_numpy(b)
    out = ts.spmm(a_t, bt, schedule=TS(nnz_tile=64, group_size=8,
                                       strategy="t_spmm_user_acc"),
                  device="cpu")
    torch.testing.assert_close(out, a_t.todense() @ bt, rtol=1e-4,
                               atol=1e-4)


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    from repro_torch.kernels import spmm_rb

    before = (teb.KERNEL.launches, spmm_rb.KERNEL.launches,
              teb.FINISH.launches)
    _, a_t, b, bias, _ = _inputs()
    bt = torch.from_numpy(b)
    ts.spmm(a_t, bt, bias=torch.from_numpy(bias), device="cpu")
    ts.spmm(a_t, bt, schedule="RB+PR", device="cpu")
    assert (teb.KERNEL.launches, spmm_rb.KERNEL.launches,
            teb.FINISH.launches) == before
