"""User-defined reduction strategies in the port against the JAX package,
on the CPU: EB SpMM, segment reduce and the GCN (forward and gradients)
under strategies registered in both packages with the same semantics
(quickstart's ``"onehot-tile"``, a spec alone, ``combine="max"``, a
callable combine with its identity), the JAX kernels in interpret mode,
inputs built by numpy from a seed; and the tile walk the card runs
(``kernels/common.py::run_user_strategy``: windows of whole tiles, the
reference's contract of global ids and whole blocks) with the partials
and combine wrappers' plain versions.

Tolerances: f32 results of add 1e-5 relative (and 1e-5 absolute): the
one-hot product and the segment sums add the same terms in other
orders; max and min bit for bit (NaN where NaN, every other value with
its bits); an fp16 output one fp16 step (2^-10 relative); gradients
1e-4, as they sum products of two such results.
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
from repro.core import register_strategy as j_register
from repro.models.layers import gcn_layer as jax_gcn_layer
from repro_torch.core import MONOIDS
from repro_torch.core import Epilogue as TE
from repro_torch.core import Schedule as TS
from repro_torch.core import get_strategy
from repro_torch.core import register_strategy as t_register
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import eb_partials as tpart
from repro_torch.kernels import segment_reduce as tseg
from repro_torch.kernels import spmm_eb as teb
from repro_torch.models import GCN

RTOL = ATOL = 1e-5
F16_TOL = 2.0 ** -10
GRAD_TOL = 1e-4
N_DENSE = 12


# quickstart's "onehot-tile": a one-hot matmul per tile, spec and
# realization, in both packages
def _j_onehot_spec(partials, seg_ids, num_segments, group_size):
    onehot = (seg_ids[:, None]
              == jnp.arange(num_segments)[None, :]).astype(partials.dtype)
    return jnp.einsum("ts,tc->sc", onehot, partials)


def _j_onehot_pallas(rows, partial, out_ref, group_size):
    s = out_ref.shape[0]
    onehot = (rows[:, None] == jax.lax.broadcasted_iota(
        jnp.int32, (rows.shape[0], s), 1)).astype(partial.dtype)
    out_ref[...] += jnp.dot(onehot.T, partial,
                            preferred_element_type=jnp.float32)


def _t_onehot(ids, num_segments, dtype):
    return (ids[:, None] == torch.arange(
        num_segments, device=ids.device)[None, :]).to(dtype)


def _t_onehot_spec(partials, seg_ids, num_segments, group_size):
    return _t_onehot(seg_ids, num_segments, partials.dtype).T @ partials


def _t_onehot_kernel(rows, partial, out, group_size):
    out += _t_onehot(rows, out.shape[0], partial.dtype).T @ partial


# a spec that reduces under whatever monoid it is given
def _j_generic_spec(p, s, n, g, monoid=None):
    return monoid.seg_reduce(p, s, n)


def _t_generic_spec(p, s, n, g, monoid=None):
    return monoid.seg_reduce(p, s, n)


def _j_max_spec(p, s, n, g, monoid=None):
    return jax.ops.segment_max(p, s, num_segments=n)


def _t_max_spec(p, s, n, g, monoid=None):
    return torch.full((n, p.shape[1]), -float("inf"),
                      device=p.device).scatter_reduce_(
        0, s.long()[:, None].expand_as(p), p, "amax")


STRATEGIES = {
    # name: (JAX registration, port registration)
    "t_us_onehot": (dict(spec_fn=_j_onehot_spec, pallas_fn=_j_onehot_pallas),
                    dict(spec_fn=_t_onehot_spec, kernel_fn=_t_onehot_kernel)),
    "t_us_spec": (dict(spec_fn=_j_onehot_spec),
                  dict(spec_fn=_t_onehot_spec)),
    "t_us_generic": (dict(spec_fn=_j_generic_spec),
                     dict(spec_fn=_t_generic_spec)),
    "t_us_max": (dict(spec_fn=_j_max_spec, combine="max"),
                 dict(spec_fn=_t_max_spec, combine="max")),
    "t_us_callable": (dict(spec_fn=_j_max_spec, combine=jnp.maximum,
                           identity=-float("inf")),
                      dict(spec_fn=_t_max_spec, combine=torch.maximum,
                           identity=-float("inf"))),
}


@pytest.fixture(scope="module", autouse=True)
def _registered():
    for name, (j_kw, t_kw) in STRATEGIES.items():
        j_register(name, overwrite=True, **j_kw)
        t_register(name, overwrite=True, **t_kw)


def _matrix(n=96, seed=0):
    a_j = js.power_law_csr(n, n, avg_degree=5.0, alpha=1.6, seed=seed)
    a_t = ts.power_law_csr(n, n, avg_degree=5.0, alpha=1.6, seed=seed,
                           device="cpu")
    return a_j, a_t


def _assert_bits(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep].view(np.int32),
                                  want[keep].view(np.int32))


def _assert_same(got, want, strategy):
    if strategy in ("t_us_max", "t_us_callable"):
        _assert_bits(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _spmm_both(strategy, *, ep=None, value_dtype=None, skew=None, seed=0):
    a_j, a_t = _matrix(seed=seed)
    rng = np.random.default_rng(seed + 7)
    b = rng.standard_normal((a_t.shape[1], N_DENSE)).astype(np.float32)
    bias = rng.standard_normal(N_DENSE).astype(np.float32)
    res = rng.standard_normal((a_t.shape[0], N_DENSE)).astype(np.float32)
    ep = ep or {}
    use_bias = ep.pop("bias", False)
    use_res = ep.pop("residual", False)
    kw = dict(kernel="eb", nnz_tile=64, col_tile=8, group_size=8,
              strategy=strategy, value_dtype=value_dtype, **(skew or {}))
    out_j = js.spmm(a_j, jnp.asarray(b), schedule=JS(**kw),
                    bias=jnp.asarray(bias) if use_bias else None,
                    residual=jnp.asarray(res) if use_res else None,
                    epilogue=JE(**ep), interpret=True)
    out_t = ts.spmm(a_t, torch.from_numpy(b), schedule=TS(**kw),
                    bias=torch.from_numpy(bias) if use_bias else None,
                    residual=torch.from_numpy(res) if use_res else None,
                    epilogue=TE(**ep), device="cpu")
    return out_t, np.asarray(out_j), (a_t, b, kw)


@pytest.mark.parametrize("strategy", ["t_us_onehot", "t_us_spec",
                                      "t_us_max", "t_us_callable"])
def test_eb_under_a_user_strategy_matches_reference(strategy):
    got, want, _ = _spmm_both(strategy)
    assert got.dtype == torch.float32
    _assert_same(got.numpy(), want, strategy)


@pytest.mark.parametrize("ep", [
    dict(activation="relu", bias=True, residual=True),
    dict(activation="gelu", bias=True, out_dtype="float16")],
    ids=["bias+relu+residual", "bias+gelu+fp16"])
def test_eb_user_strategy_epilogue_matches_reference(ep):
    fp16 = ep.get("out_dtype") == "float16"
    got, want, _ = _spmm_both("t_us_onehot", ep=dict(ep))
    assert got.dtype == (torch.float16 if fp16 else torch.float32)
    tol = F16_TOL if fp16 else RTOL
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("strategy,value_dtype", [
    ("t_us_onehot", "bfloat16"), ("t_us_max", "int8")])
def test_eb_user_strategy_narrow_storage_matches_reference(strategy,
                                                           value_dtype):
    got, want, _ = _spmm_both(strategy, value_dtype=value_dtype)
    _assert_same(got.numpy(), want, strategy)


@pytest.mark.parametrize("strategy", ["t_us_onehot", "t_us_max"])
def test_eb_user_strategy_on_the_skew_layout_matches_reference(strategy,
                                                               monkeypatch):
    """The leading heavy tiles run the built-in ``parallel`` (added into
    the accumulator by the combine), the rest the user's code; also
    through ``spmm_eb_user`` itself with windows of one tile.  The heavy
    rows are sums (1e-5) under either strategy; the others, under
    ``t_us_max``, maxima (bit for bit)."""
    skew = dict(split_threshold=12, merge_threshold=0)
    got, want, (a_t, b, kw) = _spmm_both(strategy, skew=skew)
    g = a_t.grouped(64, group_size=8, **skew)
    assert g.heavy_tiles > 0
    heavy = np.zeros(a_t.shape[0], bool)
    heavy[g.rows[:g.heavy_tiles * 64].long().numpy()] = True
    monkeypatch.setattr(tcommon, "WINDOW_BYTES", 64 * N_DENSE * 4)
    walked = teb.spmm_eb_user(g.rows, g.cols, g.vals, torch.from_numpy(b),
                              n_rows=a_t.shape[0], nnz_tile=64, group_size=8,
                              strategy=strategy, heavy_tiles=g.heavy_tiles)
    for out in (got.numpy(), walked.numpy()):
        np.testing.assert_allclose(out[heavy], want[heavy], rtol=RTOL,
                                   atol=ATOL)
        _assert_same(out[~heavy], want[~heavy], strategy)


def _segments(t, n_seg, c, seed, hub=None):
    """Sorted ids in [0, n_seg) (some segments empty) and f32 data; with
    ``hub`` = (segment, lanes), that segment holds ``lanes`` lanes."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n_seg, t)
    if hub is not None:
        seg = np.concatenate([seg, np.full(hub[1], hub[0])])
    seg = np.sort(seg).astype(np.int32)
    data = rng.standard_normal((seg.shape[0], c)).astype(np.float32)
    return seg, data


@pytest.mark.parametrize("strategy,op", [
    ("t_us_generic", "sum"), ("t_us_generic", "max"), ("t_us_generic", "min"),
    ("t_us_generic", "mean"), ("t_us_onehot", "sum"), ("t_us_max", "sum")])
def test_segment_reduce_user_strategy_matches_reference(strategy, op):
    """Ragged T (not a tile multiple) and segment 5 spanning many tiles."""
    seg, data = _segments(203, 30, 5, seed=3, hub=(5, 150))
    kw = dict(kernel="eb", nnz_tile=32, group_size=8, strategy=strategy)
    want = np.asarray(js.segment_reduce(jnp.asarray(seg), jnp.asarray(data),
                                        30, schedule=JS(**kw), op=op))
    got = ts.segment_reduce(torch.from_numpy(seg), torch.from_numpy(data),
                            30, schedule=TS(**kw), op=op, device="cpu")
    if op in ("max", "min") or strategy == "t_us_max":
        _assert_bits(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op", ["add", "max"])
def test_segment_reduce_user_count_column_matches_builtin(op):
    """``count_column`` under a user strategy: the data's columns as the
    built-in reduces them, and the lanes of each segment (under max, 1
    where a segment has any)."""
    seg, data = _segments(150, 20, 3, seed=4, hub=(11, 90))
    s, d = torch.from_numpy(seg), torch.from_numpy(data)
    got = tseg.segment_reduce(s, d, num_segments=20, tile=32, group_size=8,
                              strategy="t_us_generic", op=op,
                              count_column=True)
    want = tseg.segment_reduce(s, d, num_segments=20, tile=32, group_size=8,
                               op=op, count_column=True)
    if op == "max":
        _assert_bits(got.numpy(), want.numpy())
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)
    counts = np.bincount(seg, minlength=20).astype(np.float32)
    np.testing.assert_array_equal(
        got[:, -1].numpy(), counts if op == "add" else np.where(
            counts > 0, 1.0, -np.inf).astype(np.float32))


def _gcn_setup(n=64, f=16, c=4):
    rng = np.random.default_rng(0)
    adj = js.random_csr(n, n, density=0.06, seed=0)
    dense = np.asarray(adj.todense())
    dense = ((dense + dense.T) > 0).astype(np.float32)
    np.fill_diagonal(dense, 1.0)
    deg = dense.sum(1)
    norm = dense / np.sqrt(np.outer(deg, deg))
    feats = rng.standard_normal((n, f)).astype(np.float32)
    labels = rng.integers(0, c, n)
    params = {"w1": (rng.standard_normal((f, 32)) * 0.3).astype(np.float32),
              "b1": (rng.standard_normal(32) * 0.1).astype(np.float32),
              "w2": (rng.standard_normal((32, c)) * 0.3).astype(np.float32)}
    return norm, feats, labels, params


def test_gcn_under_a_user_strategy_matches_reference_and_jax_grad():
    """Forward and gradients of the two-layer GCN under quickstart's
    strategy; the port's backward recomputes the relu's input under the
    same schedule, so the user's code runs in the backward too."""
    norm, feats, labels, params = _gcn_setup()
    kw = dict(kernel="eb", nnz_tile=64, col_tile=8, group_size=8,
              strategy="t_us_onehot")
    a_j = js.CSR.fromdense(norm)

    def loss_fn(p, x, y):
        h = jax_gcn_layer(a_j, x, p["w1"], p["b1"], activation="relu",
                          schedule=JS(**kw))
        logits = js.spmm(a_j, h @ p["w2"], schedule=JS(**kw))
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(y)), y])

    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    loss_j, grads_j = jax.value_and_grad(loss_fn)(
        p_j, jnp.asarray(feats), jnp.asarray(labels))

    a_t = ts.CSR.fromdense(norm, device="cpu")
    model = GCN.from_jax_params(params, schedule=TS(**kw), device="cpu")
    logits = model(a_t, torch.from_numpy(feats))
    logits_j = js.spmm(a_j, jax.nn.relu(
        js.spmm(a_j, jnp.asarray(feats) @ p_j["w1"], schedule=JS(**kw))
        + p_j["b1"]) @ p_j["w2"], schedule=JS(**kw))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=RTOL, atol=ATOL)
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=GRAD_TOL)
    for k in ("w1", "b1", "w2"):
        np.testing.assert_allclose(getattr(model, k).grad.numpy(),
                                   np.asarray(grads_j[k]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_run_user_strategy_hands_offset_ids_and_row_views(monkeypatch):
    """The reference's contract (the name is kept from the offset
    contract it once pinned): each tile's realization gets the tile's
    global row ids and ``out`` = the whole accumulator (written in
    place), and the spec ``num_segments`` = the accumulator's height;
    windows of whole tiles no larger than ``WINDOW_BYTES`` give the
    one-window result."""
    rng = np.random.default_rng(5)
    tile, c, n_rows = 16, 3, 50
    rows = torch.from_numpy(np.sort(rng.integers(3, n_rows, 6 * tile))
                            .astype(np.int32))
    partial = torch.from_numpy(rng.standard_normal((6 * tile, c))
                               .astype(np.float32))
    seen, specs, windows = [], [], []

    def kernel(ids, part, out, group_size):
        seen.append((ids.clone(), part.clone(), out.shape, out.data_ptr()))
        out += _t_onehot(ids, out.shape[0], part.dtype).T @ part

    def spec(part, ids, num_segments, group_size):
        specs.append((ids.clone(), num_segments))
        return _t_onehot(ids, num_segments, part.dtype).T @ part

    t_register("t_us_record", spec, kernel, overwrite=True)
    t_register("t_us_record_spec", spec, overwrite=True)

    def partials(t0, t1):
        windows.append((t0, t1))
        return partial[t0:t1]

    acc = torch.zeros(n_rows, c)
    monkeypatch.setattr(tcommon, "WINDOW_BYTES", 2 * tile * c * 4)
    tcommon.run_user_strategy(get_strategy("t_us_record"), rows, acc,
                              group_size=8, nnz_tile=tile, partials=partials,
                              combine=tcommon.combine_plain)
    monkeypatch.undo()
    assert windows == [(0, 32), (32, 64), (64, 96)]
    assert len(seen) == 6
    for k, (ids, part, shape, addr) in enumerate(seen):
        assert torch.equal(ids, rows[k * tile:(k + 1) * tile])
        assert torch.equal(part, partial[k * tile:(k + 1) * tile])
        assert shape == (n_rows, c)
        assert addr == acc.data_ptr()
    want = torch.zeros(n_rows, c).index_add_(0, rows.long(), partial)
    torch.testing.assert_close(acc, want, rtol=RTOL, atol=ATOL)

    acc2 = torch.zeros(n_rows, c)
    tcommon.run_user_strategy(get_strategy("t_us_record_spec"), rows, acc2,
                              group_size=8, nnz_tile=tile,
                              partials=lambda t0, t1: partial[t0:t1],
                              combine=tpart.combine)
    assert [int(n) for _, n in specs] == [n_rows] * 6
    assert all(torch.equal(ids, s[0]) for (ids, _), s in zip(specs, seen))
    torch.testing.assert_close(acc2, acc, rtol=0, atol=0)
    with pytest.raises(ValueError, match="outside"):
        tcommon.run_user_strategy(get_strategy("t_us_record"), rows,
                                  torch.zeros(n_rows - 10, c), group_size=8,
                                  nnz_tile=tile,
                                  partials=lambda t0, t1: partial[t0:t1],
                                  combine=tcommon.combine_plain)


# a strategy whose answer depends on the ids themselves: each lane's
# partial weighted by its id, in both packages; the n each call is given
# is recorded (a Python int in JAX's trace too)
_ID_NS = {"jax": [], "torch": []}


def _j_idweight(p, s, n):
    return jax.ops.segment_sum(p * s[:, None].astype(p.dtype), s,
                               num_segments=n)


def _j_idweight_spec(p, s, n, g):
    _ID_NS["jax"].append(n)
    return _j_idweight(p, s, n)


def _j_idweight_pallas(rows, partial, out_ref, group_size):
    _ID_NS["jax"].append(out_ref.shape[0])
    out_ref[...] += _j_idweight(partial, rows, out_ref.shape[0])


def _t_idweight(p, s, n):
    return torch.zeros(n, p.shape[1]).index_add_(
        0, s.long(), p * s[:, None].to(p.dtype))


def _t_idweight_spec(p, s, n, g):
    _ID_NS["torch"].append(n)
    return _t_idweight(p, s, n)


def _t_idweight_kernel(rows, partial, out, group_size):
    _ID_NS["torch"].append(out.shape[0])
    out += _t_idweight(partial, rows, out.shape[0])


@pytest.mark.parametrize("with_realization", [False, True],
                         ids=["spec", "realization"])
def test_id_dependent_strategy_pins_the_offset_divergence(with_realization):
    """A strategy that reads an id's value gives the reference's answer
    (the name is kept from the offset contract it once pinned): both
    packages hand it global row ids and ``num_segments = n_rows`` (the
    realization the whole (n_rows, N) block), so weighting each partial
    by its id gives ``out[r] = r * S[r]`` on both sides (``S`` the plain
    sums of row r's partials), within 1e-5 of the largest magnitude (the
    weights reach 95)."""
    name = "t_us_idweight" + ("_rz" if with_realization else "")
    j_register(name, spec_fn=_j_idweight_spec, overwrite=True,
               **({"pallas_fn": _j_idweight_pallas}
                  if with_realization else {}))
    t_register(name, _t_idweight_spec,
               _t_idweight_kernel if with_realization else None,
               overwrite=True)
    for v in _ID_NS.values():
        v.clear()
    got, want, (a_t, b, kw) = _spmm_both(name)
    got = got.numpy()
    g = a_t.grouped(kw["nnz_tile"], group_size=kw["group_size"])
    rows = g.rows.long()
    part = tpart.eb_partials_plain(g.rows, g.cols, g.vals,
                                   torch.from_numpy(b)).double()
    n = a_t.shape[0]
    global_w = torch.zeros(n, b.shape[1], dtype=torch.float64).index_add_(
        0, rows, part * rows[:, None].double()).numpy()
    tol = 1e-5 * np.abs(global_w).max()
    np.testing.assert_allclose(want, global_w, rtol=0, atol=tol)
    np.testing.assert_allclose(got, global_w, rtol=0, atol=tol)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert set(_ID_NS["jax"]) == {n}
    assert _ID_NS["torch"] == [n] * (rows.numel() // kw["nnz_tile"])


@pytest.mark.parametrize("strategy", ["segment", "t_us_idweight",
                                      "t_us_idweight_rz"])
def test_local_spmm_hands_a_user_strategy_global_ids(strategy):
    """Each rank's shard-local SpMM of an nnz split (P = 2, nnz tile 64)
    under the id-weighting strategy equals the reference's
    ``_local_spmm``: the user's code is handed the global row ids and
    ``num_segments = n_rows`` on every rank (the port once rebased both
    to the rows a slice covers and missed by 14.68 and 1607.2).  Under
    the built-in ``segment`` the port's narrow row window gives the
    reference's bits."""
    import repro.sparse.distributed as jd
    import repro_torch.sparse.distributed as td

    if strategy != "segment":
        rz = strategy.endswith("_rz")
        j_register(strategy, spec_fn=_j_idweight_spec, overwrite=True,
                   **({"pallas_fn": _j_idweight_pallas} if rz else {}))
        t_register(strategy, _t_idweight_spec,
                   _t_idweight_kernel if rz else None, overwrite=True)
    for v in _ID_NS.values():
        v.clear()
    a_j, a_t = _matrix(seed=0)
    n = a_t.shape[0]
    b = np.random.default_rng(7).standard_normal(
        (a_t.shape[1], N_DENSE)).astype(np.float32)
    kw = dict(kernel="eb", nnz_tile=64, col_tile=8, group_size=8,
              strategy=strategy)
    rj, cj, vj, _ = jd.partition_nnz_coo(a_j, 2, 64)
    rt, ct, vt, _ = td.partition_nnz_coo(a_t, 2, 64)
    half = rt.shape[0] // 2
    for lo in (0, half):
        want = np.asarray(jd._local_spmm(
            rj[lo:lo + half], cj[lo:lo + half], vj[lo:lo + half],
            jnp.asarray(b), n, JS(**kw), interpret=True))
        got = td._local_spmm(rt[lo:lo + half], ct[lo:lo + half],
                             vt[lo:lo + half], torch.from_numpy(b), n,
                             TS(**kw)).numpy()
        if strategy == "segment":
            _assert_bits(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
    if strategy != "segment":
        assert set(_ID_NS["jax"]) == {n}
        assert set(_ID_NS["torch"]) == {n}


def test_partials_and_combine_take_their_plain_versions_on_the_cpu():
    """``eb_partials`` is ``eb_partials_plain`` on CPU tensors (bf16 and
    int8 codes with their rows' scales, as the EB kernel's lanes), and
    ``combine`` the monoid's combine, -0.0 below +0.0 under max; a
    result of another shape is refused; neither counts a launch."""
    rng = np.random.default_rng(6)
    rows = torch.from_numpy(np.sort(rng.integers(0, 20, 64))
                            .astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, 30, 64).astype(np.int32))
    b = torch.from_numpy(rng.standard_normal((30, 8)).astype(np.float32))
    before = (tpart.KERNEL.launches, tpart.COMBINE.launches)
    v = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    got = tpart.eb_partials(rows, cols, v.to(torch.bfloat16),
                            b.to(torch.bfloat16), n_rows=20)
    want = (v.to(torch.bfloat16).float()[:, None]
            * b.to(torch.bfloat16).float()[cols.long()])
    assert torch.equal(got, want)
    codes = torch.from_numpy(rng.integers(-127, 128, 64).astype(np.int8))
    scales = torch.from_numpy(rng.random(20).astype(np.float32))
    got = tpart.eb_partials(rows, cols, codes, b.to(torch.bfloat16),
                            n_rows=20, scales=scales)
    assert torch.equal(got, tpart.lane_values(codes, rows, scales)[:, None]
                       * b.to(torch.bfloat16).float()[cols.long()])
    acc = torch.tensor([[0.0, -0.0, 1.0, float("nan")]])
    tile = torch.tensor([[-0.0, 0.0, 2.0, 0.0]])
    tpart.combine(acc, tile, MONOIDS["max"])
    _assert_bits(acc.numpy(), np.array([[0.0, 0.0, 2.0, np.nan]],
                                       np.float32))
    with pytest.raises(ValueError, match="tile result"):
        tpart.combine(acc, tile[:, :2], MONOIDS["add"])
    assert (tpart.KERNEL.launches, tpart.COMBINE.launches) == before
