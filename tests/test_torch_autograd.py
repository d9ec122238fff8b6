"""The port's differentiable ``spmm`` (the kernels' plain versions on the
CPU) against ``jax.grad`` through the JAX package's ``spmm``, whose
Pallas forward runs in interpret mode; the layouts carrying fresh values;
``make_spmm``; and three SGD steps of ``examples/gcn_spmm.py``'s GCN in
both packages from the same parameters.

Tolerances: gradients compare at rtol = atol = 1e-5 (each is one sparse
product of f32 values summed in another order).  The training run
compares at 1e-4: three steps at lr 0.5 chain a dozen such products,
and each step's update feeds the next.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as js
import repro_torch.sparse as ts
from repro.core import Epilogue as JE
from repro.core import Schedule as JS
from repro.models.layers import gcn_layer as jax_gcn_layer
from repro.sparse.autodiff import make_spmm as jax_make_spmm
from repro_torch.core import Epilogue as TE
from repro_torch.core import Schedule as TS
from repro_torch.models import GCN
from repro_torch.sparse.autodiff import make_spmm

RTOL = ATOL = 1e-5
TRAIN_TOL = 1e-4
N_DENSE = 10

SCHEDULES = {
    "eb-segment": dict(kernel="eb", nnz_tile=32, col_tile=8, group_size=8,
                       strategy="segment"),
    "eb-accumulate": dict(kernel="eb", nnz_tile=32, col_tile=8,
                          group_size=8, strategy="accumulate"),
    "rb": dict(kernel="rb", row_tile=8, col_tile=8),
    "skew": dict(kernel="eb", nnz_tile=32, col_tile=8, group_size=8,
                 strategy="segment", split_threshold=8, merge_threshold=2),
}


def _inputs(n=64, seed=0):
    a_j = js.power_law_csr(n, n, avg_degree=5.0, alpha=1.6, seed=seed)
    a_t = ts.power_law_csr(n, n, avg_degree=5.0, alpha=1.6, seed=seed,
                           device="cpu")
    rng = np.random.default_rng(seed + 100)
    b = rng.standard_normal((n, N_DENSE)).astype(np.float32)
    bias = rng.standard_normal(N_DENSE).astype(np.float32)
    res = rng.standard_normal((n, N_DENSE)).astype(np.float32)
    cot = rng.standard_normal((n, N_DENSE)).astype(np.float32)
    return a_j, a_t, b, bias, res, cot


@pytest.mark.parametrize("epilogue", ["none", "relu+bias+residual"])
@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_spmm_grads_match_reference(sched, epilogue):
    a_j, a_t, b, bias, res, cot = _inputs()
    full = epilogue != "none"
    ep_kw = dict(activation="relu") if full else {}

    def jax_loss(vals, bb, bias_x, res_x, schedule):
        a = js.CSR(indptr=a_j.indptr, indices=a_j.indices, vals=vals,
                   shape=a_j.shape)
        out = js.spmm(a, bb, schedule=JS(**schedule),
                      bias=bias_x if full else None,
                      residual=res_x if full else None,
                      epilogue=JE(**ep_kw), interpret=True)
        return jnp.sum(out * cot)

    # the JAX RB path converts the CSR to ELL on the host, so its values
    # cannot be traced; its backward does not depend on the kernel, so
    # the gradient in vals comes from the EB path there
    vals_sched = SCHEDULES["eb-segment" if sched == "rb" else sched]
    dense_args = (jnp.asarray(b), jnp.asarray(bias), jnp.asarray(res))
    want = (jax.grad(jax_loss)(a_j.vals, *dense_args, vals_sched),
            *jax.grad(lambda *xs: jax_loss(a_j.vals, *xs, SCHEDULES[sched]),
                      argnums=(0, 1, 2))(*dense_args))
    a_t.vals.requires_grad_()
    leaves = [a_t.vals] + [torch.from_numpy(x).requires_grad_()
                           for x in (b, bias, res)]
    out = ts.spmm(a_t, leaves[1], TS(**SCHEDULES[sched]),
                  bias=leaves[2] if full else None,
                  residual=leaves[3] if full else None,
                  epilogue=TE(**ep_kw), device="cpu")
    out.backward(torch.from_numpy(cot))
    n_grads = 4 if full else 2
    for leaf, w in zip(leaves[:n_grads], want[:n_grads]):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)
    if not full:
        assert leaves[2].grad is None and leaves[3].grad is None


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_spmm_reads_values_changed_in_place(sched):
    """The memoized layouts are served with the CSR's current values."""
    _, a_t, b, _, _, _ = _inputs(seed=1)
    bt = torch.from_numpy(b)
    s = TS(**SCHEDULES[sched])
    ts.spmm(a_t, bt, s, device="cpu")  # warm the memo
    with torch.no_grad():
        a_t.vals.mul_(-3.0).add_(0.5)
    torch.testing.assert_close(ts.spmm(a_t, bt, s, device="cpu"),
                               a_t.todense() @ bt, rtol=1e-4, atol=1e-4)


def test_ell_scatter_index_matches_reference():
    a_j, a_t, _, _, _, _ = _inputs(seed=2)
    for got, want in zip(a_t.ell_scatter_index(), a_j.ell_scatter_index()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    e = a_t.ell(row_tile=8)
    rid, pos = a_t.ell_scatter_index()
    torch.testing.assert_close(e.vals[rid, pos], a_t.vals, rtol=0, atol=0)


def test_transposed_view_is_the_transpose():
    _, a_t, _, _, _, _ = _inputs(seed=3)
    g, perm = a_t.transposed(32)
    assert g.shape == (a_t.shape[1], a_t.shape[0])
    assert bool((g.rows[1:] >= g.rows[:-1]).all())
    assert g.nnz_padded % 32 == 0
    fresh = torch.linspace(-1.0, 1.0, a_t.nnz)
    dense = ts.CSR(a_t.indptr, a_t.indices, fresh, a_t.shape).todense()
    torch.testing.assert_close(g.with_vals(fresh[perm]).todense(), dense.T,
                               rtol=0, atol=0)
    assert a_t.transposed(32) is a_t.transposed(32)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("shuffled", [False, True])
def test_make_spmm_matches_dense_product(impl, shuffled):
    a_j, a_t, b, _, _, cot = _inputs(seed=4)
    coo = a_t.tocoo()
    if shuffled:  # an unsorted stream: make_spmm sorts it, vals follow
        perm = torch.from_numpy(np.random.default_rng(4).permutation(
            a_t.nnz))
        coo = ts.COO(coo.rows[perm], coo.cols[perm], a_t.vals[perm],
                     a_t.shape)
        a_j = js.COO(jnp.asarray(coo.rows.numpy()),
                     jnp.asarray(coo.cols.numpy()),
                     jnp.asarray(coo.vals.detach().numpy()), a_t.shape)
    fn = make_spmm(coo.rows, coo.cols, *a_t.shape, impl=impl, device="cpu")
    vals = coo.vals.detach().clone().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    out = fn(vals, bt)
    dvals, db = torch.autograd.grad(out, (vals, bt), torch.from_numpy(cot))
    dense = a_t.todense().detach().requires_grad_()
    want = dense @ bt
    ddense, db_want = torch.autograd.grad(want, (dense, bt),
                                          torch.from_numpy(cot))
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(db, db_want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(dvals, ddense[coo.rows.long(),
                                             coo.cols.long()],
                               rtol=RTOL, atol=ATOL)
    # and the reference's make_spmm agrees
    jfn = jax_make_spmm(jnp.asarray(coo.rows.numpy()),
                        jnp.asarray(coo.cols.numpy()), *a_t.shape)
    jd = jax.grad(lambda v, bb: jnp.sum(jfn(v, bb) * cot), argnums=(0, 1))(
        a_j.vals, jnp.asarray(b))
    np.testing.assert_allclose(dvals.numpy(), np.asarray(jd[0]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(jd[1]), rtol=RTOL,
                               atol=ATOL)


def _example_setup():
    """``examples/gcn_spmm.py``'s graph, features, teacher labels and
    initial parameters (256 nodes, 32 features, hidden 64, 4 classes)."""
    n, f, c = 256, 32, 4
    adj = js.random_csr(n, n, density=0.02, seed=0)
    dense = np.asarray(adj.todense())
    dense = ((dense + dense.T) > 0).astype(np.float32)
    np.fill_diagonal(dense, 1.0)
    deg = dense.sum(1)
    norm = dense / np.sqrt(np.outer(deg, deg))
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((n, f)).astype(np.float32)
    w_teacher = rng.standard_normal((f, c)).astype(np.float32)
    labels = np.argmax(norm @ feats @ w_teacher, axis=-1)
    params = {
        "w1": (rng.standard_normal((f, 64)) * 0.1).astype(np.float32),
        "b1": np.zeros(64, np.float32),
        "w2": (rng.standard_normal((64, c)) * 0.1).astype(np.float32),
    }
    return norm, feats, labels, params


def test_gcn_example_trains_like_reference():
    norm, feats, labels, params = _example_setup()
    steps, lr = 3, 0.5
    a_j = js.CSR.fromdense(norm)
    sched_j = JS.auto(js.matrix_stats(a_j), feats.shape[1])

    def loss_fn(p, x, y):
        h = jax_gcn_layer(a_j, x, p["w1"], p["b1"], activation="relu",
                          schedule=sched_j)
        logits = js.spmm(a_j, h @ p["w2"], schedule=sched_j)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(y)), y])

    step = jax.jit(jax.value_and_grad(loss_fn))
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    losses_j = []
    for _ in range(steps):
        loss, grads = step(p_j, jnp.asarray(feats), jnp.asarray(labels))
        p_j = jax.tree.map(lambda p, g: p - lr * g, p_j, grads)
        losses_j.append(float(loss))

    a_t = ts.CSR.fromdense(norm, device="cpu")
    sched_t = TS.auto(ts.matrix_stats(a_t), feats.shape[1])
    assert str(sched_t) == str(sched_j)
    model = GCN.from_jax_params(params, schedule=sched_t, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    x, y = torch.from_numpy(feats), torch.from_numpy(labels)
    losses_t = []
    for _ in range(steps):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(a_t, x), y)
        loss.backward()
        opt.step()
        losses_t.append(loss.item())

    np.testing.assert_allclose(losses_t, losses_j, rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)
    assert losses_t[-1] < losses_t[0]
    for k in ("w1", "b1", "w2"):
        np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                   np.asarray(p_j[k]), rtol=TRAIN_TOL,
                                   atol=TRAIN_TOL)
