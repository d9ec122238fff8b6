"""The port's GCN (``repro_torch.models``) against the JAX composition of
``examples/gcn_spmm.py``'s ``gcn_fwd`` (``gcn_layer`` + ``spmm``) with
the same weights, graph and features, at 200 nodes, 16 features, hidden
width 32 and 4 classes.

Tolerance: rtol = atol = 1e-5.  The two dense products run in XLA and in
torch with other summation orders; at these widths the f32 difference
stays far below it.  Gradients compare at 1e-4: they chain two such
products more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as js
import repro_torch.sparse as ts
from repro.models.layers import gcn_layer as jax_gcn_layer
from repro_torch.core import Schedule as TS
from repro_torch.models import GCN, normalized_adjacency

N_NODES, N_FEAT, HIDDEN, N_CLASS = 200, 16, 32, 4
RTOL = ATOL = 1e-5


def _setup(pattern, seed=0):
    raw = ts.graph_pattern_csr(pattern, N_NODES, seed=seed, device="cpu")
    adj_t = normalized_adjacency(raw, device="cpu")
    adj_j = js.CSR(indptr=jnp.asarray(adj_t.indptr.numpy()),
                   indices=jnp.asarray(adj_t.indices.numpy()),
                   vals=jnp.asarray(adj_t.vals.numpy()), shape=adj_t.shape)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N_NODES, N_FEAT)).astype(np.float32)
    params = {
        "w1": (rng.standard_normal((N_FEAT, HIDDEN)) * 0.1).astype(np.float32),
        "b1": (rng.standard_normal(HIDDEN) * 0.1).astype(np.float32),
        "w2": (rng.standard_normal((HIDDEN, N_CLASS)) * 0.1).astype(
            np.float32),
    }
    return raw, adj_t, adj_j, x, params


def _jax_gcn_fwd(adj, params, x, schedule):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    h = jax_gcn_layer(adj, jnp.asarray(x), p["w1"], p["b1"],
                      activation="relu", schedule=schedule)
    return js.spmm(adj, h @ p["w2"], schedule=schedule)


@pytest.mark.parametrize("pattern,schedule", [
    ("social", "auto"), ("roadnet", "auto"), ("roadnet", "RB+PR"),
    ("web", "EB+SR")])
def test_gcn_from_jax_params_matches_reference(pattern, schedule):
    _, adj_t, adj_j, x, params = _setup(pattern)
    model = GCN.from_jax_params(params, schedule=schedule, device="cpu")
    with torch.no_grad():  # serving
        got = model(adj_t, torch.from_numpy(x))
        want = _jax_gcn_fwd(adj_j, params, x, schedule)
        assert got.shape == (N_NODES, N_CLASS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        # a second request on the same CSR reuses its conversions
        cached = dict(adj_t.__dict__["_convcache"])
        torch.testing.assert_close(model(adj_t, torch.from_numpy(x)), got)
        assert adj_t.__dict__["_convcache"] == cached


def test_normalized_adjacency_matches_dense_construction():
    raw, adj_t, _, _, _ = _setup("social", seed=3)
    dense = raw.todense().numpy() != 0
    sym = (dense | dense.T).astype(np.float32)
    np.fill_diagonal(sym, 1.0)
    deg = sym.sum(1)
    want = sym / np.sqrt(np.outer(deg, deg))
    np.testing.assert_array_equal(adj_t.todense().numpy(), want)


def test_gcn_parameters_and_devices():
    """The parameters train: the gradients of the logits in x, the
    weights and the adjacency's values match ``jax.grad`` through the
    JAX composition."""
    _, adj_t, adj_j, x, params = _setup("roadnet")
    model = GCN.from_jax_params(params, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    np.testing.assert_array_equal(model.w2.detach().numpy(), params["w2"])
    cot = np.random.default_rng(5).standard_normal(
        (N_NODES, N_CLASS)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    adj_t.vals.requires_grad_()
    logits = model(adj_t, xt)
    got = torch.autograd.grad(logits, (xt, model.w1, model.b1, model.w2,
                                       adj_t.vals), torch.from_numpy(cot))

    def jax_loss(xx, p, vals):
        adj = js.CSR(indptr=adj_j.indptr, indices=adj_j.indices, vals=vals,
                     shape=adj_j.shape)
        return jnp.sum(_jax_gcn_fwd(adj, p, xx, "auto") * cot)

    want_x, want_p, want_vals = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        adj_j.vals)
    for g, w in zip(got, (want_x, want_p["w1"], want_p["b1"], want_p["w2"],
                          want_vals)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    with pytest.raises(ValueError, match="does not fit"):
        GCN.from_jax_params({**params, "b1": params["b1"][:3]},
                            device="cpu")
    gen = torch.Generator().manual_seed(0)
    m2 = GCN(N_FEAT, HIDDEN, N_CLASS, schedule=TS.named("RB+PR"),
             device="cpu", generator=gen)
    with torch.no_grad():
        assert m2(adj_t, torch.from_numpy(x)).shape == (N_NODES, N_CLASS)
