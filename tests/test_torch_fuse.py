"""Parity of the port's fusion planner and executor (``repro_torch.fuse``)
with the JAX package's (``repro.fuse``) on the same chains and numpy
inputs: the plan (per-boundary decision, split reasons, launch members,
planned launches) of every chain shape of
``tests/test_fuse_planner.py::build_case``, the grouped-matmul chains
included, and of the GCN readout (the two-layer GCN chain ending in a
``segment_reduce``); ``run_plan`` and ``run_chain_ref`` outputs; the rule
registry; and ``moe_combine``.

Tolerance: rtol = atol = 2e-4, that of ``tests/test_fuse_planner.py``:
two chained f32 SpMMs and dense products, summed in other orders by XLA
and torch.  The kernel paths here are the plain versions on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fuse as JF
import repro.sparse as js
import repro_torch.fuse as TF
import repro_torch.sparse as ts
from repro.core import Schedule as JS
from repro_torch.core import Schedule as TS

RTOL = ATOL = 2e-4

CASES = ("spmm-act", "rb-spmm-act", "spmm-bias-act", "spmm-act-res",
         "spmm-act-spmm", "spmm-segred", "gcn-readout-mean",
         "gcn-readout-max")


def _both(fn, *arrays):
    """fn(mod, sched, *arrays) built once per package: JAX arrays for
    ``repro``, CPU tensors for ``repro_torch``."""
    j = fn(JF, JS, js.random_csr, *(jnp.asarray(a) for a in arrays))
    t = fn(TF, TS, lambda *a, **k: ts.random_csr(*a, **k, device="cpu"),
           *(torch.from_numpy(a) for a in arrays))
    return j, t


def build_case(kind, m, c, seed):
    """((jax chain, jax params), (port chain, port params), x numpy) for
    one chain shape, with the inputs of the JAX planner tests."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, c)).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32)
    res = rng.normal(size=(m, c)).astype(np.float32)
    w0 = (rng.normal(size=(c, c)) * c ** -0.5).astype(np.float32)
    w1 = (rng.normal(size=(c, 3)) * c ** -0.5).astype(np.float32)
    n_seg = max(m // 3, 1)
    seg = np.sort(rng.integers(0, n_seg, size=(m,))).astype(np.int32)

    def make(F, S, csr, b, res, w0, w1, seg):
        adj = csr(m, m, 0.12, seed=seed)
        eb = S("eb", nnz_tile=64, group_size=8)
        sched = S("rb", row_tile=8) if kind.startswith("rb") else eb
        if kind in ("spmm-act", "rb-spmm-act"):
            return [F.spmm_node(sched), F.ewise("relu")], [{"a": adj}, {}]
        if kind == "spmm-bias-act":
            return ([F.spmm_node(sched), F.ewise(bias=True),
                     F.ewise("tanh")], [{"a": adj}, {"bias": b}, {}])
        if kind == "spmm-act-res":
            return ([F.spmm_node(sched), F.ewise("gelu", bias=True),
                     F.ewise(residual=True)],
                    [{"a": adj}, {"bias": b}, {"residual": res}])
        if kind == "spmm-act-spmm":
            return ([F.spmm_node(sched), F.ewise("relu", bias=True),
                     F.spmm_node(sched)],
                    [{"a": adj, "w": w0}, {"bias": b}, {"a": adj}])
        if kind == "spmm-segred":
            return ([F.spmm_node(sched),
                     F.segment_reduce_node("sum", schedule=eb)],
                    [{"a": adj}, {"seg_ids": seg, "num_segments": n_seg}])
        op = kind.rsplit("-", 1)[1]  # gcn-readout-{mean,max}
        chain, params = F.gcn_chain(adj, (w0, w1), (b, None),
                                    schedule=sched)
        return (list(chain) + [F.segment_reduce_node(op)],
                params + [{"seg_ids": seg, "num_segments": n_seg}])

    j, t = _both(make, b, res, w0, w1, seg)
    return j, t, x


def _launch_view(p):
    return [(ln.anchor.kind, ln.anchor_idx, ln.members, ln.epilogue.tag)
            for ln in p.launches]


@pytest.mark.parametrize("m,c,seed", [(24, 8, 0), (40, 5, 7)])
@pytest.mark.parametrize("kind", CASES)
def test_plan_and_outputs_match_reference(kind, m, c, seed):
    (jc, jp), (tc, tp), x = build_case(kind, m, c, seed)
    jplan, tplan = JF.plan(jc), TF.plan(tc)
    assert tplan.decision.fused == jplan.decision.fused
    assert tplan.reasons == jplan.reasons
    assert _launch_view(tplan) == _launch_view(jplan)
    assert tplan.n_launches == jplan.n_launches
    assert TF.chain_sig(tc) == JF.chain_sig(jc)
    want = np.asarray(JF.run_plan(jplan, jnp.asarray(x), jp))
    got = TF.run_plan(tplan, torch.from_numpy(x), tp, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want_ref = np.asarray(JF.run_chain_ref(jc, jnp.asarray(x), jp))
    got_ref = TF.run_chain_ref(tc, torch.from_numpy(x), tp)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), got_ref.numpy(), rtol=RTOL,
                               atol=ATOL)
    split_j, split_t = JF.split_all(jc), TF.split_all(tc)
    assert split_t.reasons == split_j.reasons
    assert split_t.n_launches == split_j.n_launches


@pytest.mark.parametrize("op", ["mean", "max"])
def test_gcn_readout_plans_three_launches(op):
    """spmm -> ewise(relu, bias) -> spmm -> segment_reduce: the ewise
    folds into the first SpMM, the reducing consumer splits with the
    reference's reason."""
    (jc, _), (tc, _), _ = build_case(f"gcn-readout-{op}", 24, 8, 0)
    p = TF.plan(tc)
    assert p.n_launches == 3
    assert p.decision.fused == (True, False, False)
    assert p.reasons[-1] == JF.plan(jc).reasons[-1]
    assert ("monoid 'max'" in p.reasons[-1]) == (op == "max")


def test_decision_and_legality():
    eb = TS("eb", nnz_tile=64, group_size=8)
    p = TF.plan([TF.spmm_node(eb), TF.ewise("relu"), TF.ewise("relu")],
                TF.FuseDecision((True, True)))
    assert p.decision.fused == (True, False)  # a decision never forces
    p = TF.plan([TF.spmm_node(eb), TF.ewise("relu")],
                TF.FuseDecision((False,)))
    assert p.reasons == ("split by decision",) and len(p.launches) == 2
    p = TF.plan([TF.segment_reduce_node("sum"), TF.ewise("relu")])
    assert "no in-kernel epilogue slot" in p.reasons[0]
    assert not p.launches[1].is_kernel and p.n_launches == 1
    with pytest.raises(ValueError, match="empty chain"):
        TF.plan([])
    with pytest.raises(ValueError, match="unknown node kind"):
        TF.FuseNode("conv")


def test_vetoing_rule_registered_and_unregistered():
    eb = TS("eb", nnz_tile=64, group_size=8)
    chain = [TF.spmm_node(eb), TF.ewise("relu")]
    TF.register_rule("t-veto", lambda launch, node: (None, "vetoed")
                     if node.kind == "ewise" else None,
                     before="epilogue-fold")
    try:
        assert TF.available_rules()[0] == "t-veto"
        p = TF.plan(chain)
        assert p.decision.fused == (False,) and p.reasons == ("vetoed",)
        assert TF.can_fuse(p.launches[0], chain[1]) == (None, "vetoed")
        with pytest.raises(ValueError, match="already registered"):
            TF.register_rule("t-veto", lambda launch, node: None)
    finally:
        TF.unregister_rule("t-veto")
    assert TF.available_rules() == ("epilogue-fold", "monoid-split")
    assert TF.plan(chain).decision.fused == (True,)


@pytest.mark.parametrize("op", ["sum", "min", "mean"])
def test_moe_combine_matches_reference(op):
    rng = np.random.default_rng(4)
    y = rng.normal(size=(24, 6)).astype(np.float32)
    topi = rng.integers(0, 10, size=(24,)).astype(np.int32)  # 10..11 empty
    topv = rng.uniform(0.1, 1.0, size=(24,)).astype(np.float32)
    want = JF.moe_combine(jnp.asarray(y), jnp.asarray(topi),
                          jnp.asarray(topv), 12, op=op)
    got = TF.moe_combine(torch.from_numpy(y), torch.from_numpy(topi),
                         torch.from_numpy(topv), 12, op=op)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="moe_combine op"):
        TF.moe_combine(torch.from_numpy(y), torch.from_numpy(topi),
                       torch.from_numpy(topv), 12, op="max")


def test_grouped_matmul_anchor_raises_until_its_kernel_is_ported():
    """The kernel is ported (2.11), so the anchor runs: the MoE expert
    chain (grouped matmul -> per-expert bias + SiLU) plans as one launch
    and ``run_plan`` and ``run_chain_ref`` match the reference's."""
    x, te, w, b = _gmm_problem(9)
    jc, jp = JF.moe_expert_chain(jnp.asarray(te), jnp.asarray(w),
                                 jnp.asarray(b), **GMM_TILES)
    tc, tp = TF.moe_expert_chain(torch.from_numpy(te), torch.from_numpy(w),
                                 torch.from_numpy(b), **GMM_TILES)
    p = TF.plan(tc)
    assert p.n_launches == 1 and p.decision.fused == (True,)
    assert _launch_view(p) == _launch_view(JF.plan(jc))
    want = np.asarray(JF.run_plan(JF.plan(jc), jnp.asarray(x), jp))
    got = TF.run_plan(p, torch.from_numpy(x), tp, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want_ref = np.asarray(JF.run_chain_ref(jc, jnp.asarray(x), jp))
    got_ref = TF.run_chain_ref(tc, torch.from_numpy(x), tp)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, rtol=RTOL,
                               atol=ATOL)


#: token_tile, f_tile and d_tile of the grouped-matmul chains
GMM_TILES = {"token_tile": 16, "f_tile": 16, "d_tile": 16}


def _gmm_problem(seed, t_tiles=4, d=32, f=32, e=4):
    """The inputs of ``tests/test_fuse_planner.py::_gmm_problem``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t_tiles * GMM_TILES["token_tile"], d)).astype(
        np.float32)
    te = rng.integers(0, e, size=(t_tiles,)).astype(np.int32)
    w = (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32)
    b = rng.normal(size=(e, f)).astype(np.float32)
    return x, te, w, b


@pytest.mark.parametrize("kind", ["gmm-act", "gmm-bias-act",
                                  "gmm-act-combine"])
def test_grouped_matmul_chains_match_reference(kind):
    """The grouped-matmul chain shapes of the reference's planner tests:
    the same plans, and outputs that match ``repro.fuse``'s."""
    x, te, w, b = _gmm_problem(3)
    rng = np.random.default_rng(4)
    s = x.shape[0]
    topi = rng.integers(0, s // 2, size=(s,)).astype(np.int32)
    topv = rng.uniform(0.1, 1.0, size=(s,)).astype(np.float32)

    def make(F, arr):
        gp = {"tile_experts": arr(te), "weights": arr(w), **GMM_TILES}
        if kind == "gmm-act":
            return [F.grouped_matmul_node(), F.ewise("silu")], [gp, {}]
        if kind == "gmm-bias-act":
            return ([F.grouped_matmul_node(), F.ewise("silu", bias=True)],
                    [gp, {"bias": arr(b)}])
        return ([F.grouped_matmul_node(), F.ewise("silu"),
                 F.combine_node("sum")],
                [gp, {}, {"topi": arr(topi), "topv": arr(topv),
                          "num_tokens": s // 2}])

    (jc, jp), (tc, tp) = make(JF, jnp.asarray), make(TF, torch.from_numpy)
    jplan, tplan = JF.plan(jc), TF.plan(tc)
    assert tplan.decision.fused == jplan.decision.fused
    assert tplan.reasons == jplan.reasons
    assert _launch_view(tplan) == _launch_view(jplan)
    want = np.asarray(JF.run_plan(jplan, jnp.asarray(x), jp))
    got = TF.run_plan(tplan, torch.from_numpy(x), tp, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want_ref = np.asarray(JF.run_chain_ref(jc, jnp.asarray(x), jp))
    got_ref = TF.run_chain_ref(tc, torch.from_numpy(x), tp)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, rtol=RTOL,
                               atol=ATOL)


def test_run_plan_checks_params_and_device():
    (_, _), (tc, tp), x = build_case("spmm-act", 24, 8, 0)
    with pytest.raises(ValueError, match="params"):
        TF.run_plan(TF.plan(tc), torch.from_numpy(x), tp[:1], device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        TF.run_plan(TF.plan(tc), torch.from_numpy(x).to("meta"), tp,
                    device="cpu")
