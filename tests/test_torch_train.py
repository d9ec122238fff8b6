"""Parity of the port's LM training stack with the JAX package on the same
numpy inputs: the LM loss and its gradients (``models.transformer.
loss_fn`` through ``get_model(cfg).loss``) for the smoke Qwen3-MoE (the
reference on its Pallas grouped matmul in interpret mode, the port on the
grouped matmul's plain versions, forward and backward) and the smoke
qwen2-7b; AdamW, ``global_norm``, clipping and both schedules
(``train.optimizer``); ``compress_tree`` (``distributed.collectives``);
the checkpoint manager (``checkpoint.manager``, the reference's tests of
``tests/test_substrate.py`` mirrored); heartbeats, stragglers and the
elastic plan (``distributed.fault_tolerance``); the token stream
(``data.synthetic``, bit for bit); and ``train.trainer.Trainer`` over 5
steps (full batch, 2 microbatches, int8 gradient compression) and a
restart from its checkpoint.  One JAX run per case is shared through
module fixtures.

Tolerances: loss 1e-5 relative and every gradient leaf 1e-4 relative L2
(f32 sums in another order through two layers, the tied embedding and,
for MoE, the gate-weighted combine); the optimizer 1e-6 relative (the
same f32 operations on the same values, the global norm summed in
another order; a power and a square root may round differently) with an
absolute floor of 1e-8 for parameters that cancel to near 0; the
trainer's losses 1e-4 relative over 5 steps.
"""
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke
from repro.data.synthetic import ShardedTokenStream as JStream
from repro.distributed import collectives as jcoll
from repro.distributed import fault_tolerance as jft
from repro.models import get_model as jget_model
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
from repro_torch.data.synthetic import ShardedTokenStream
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.distributed.collectives import compress_tree, decompress_tree
from repro_torch.models import get_model
from repro_torch.models.transformer import AUX_WEIGHT, params_from_jax
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import (
    TrainState,
    init_state,
    make_train_step,
)
from repro_torch.train.trainer import Trainer, TrainerConfig

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
OPT_RTOL, OPT_ATOL = 1e-6, 1e-8
TRAINER_RTOL = 1e-4
MOE, DENSE = "qwen3-moe-235b-a22b", "qwen2-7b"


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _one_host(tr):
    """``tr`` with its straggler check off: with one host the check holds
    the host's latest step times against its own median, and a loaded
    CPU's timing noise can end a run early with an elastic plan."""
    tr.monitor.straggler_factor = math.inf
    return tr


def _grads(api, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = api.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), grads


# ---------------------------------------------------------------- loss


def _jax_loss_unscanned(cfg, params, batch):
    """The reference's ``transformer.loss_fn`` with its layers in a Python
    loop.  Under its ``lax.scan`` over layers, the reference's Pallas
    grouped matmul cannot be differentiated: the tile map is a tracer of
    the scan's body that the kernel's custom VJP closes over, and
    ``jax.grad`` raises ``UnexpectedTracerError``; composed from the same
    functions without the scan, it can."""
    from repro.models import layers as jl
    from repro.models import transformer as jt

    x = jl.embed(params["embed"], batch["tokens"]).astype(cfg.compute_dtype)
    positions = jnp.arange(x.shape[1])
    aux = jnp.zeros((), jnp.float32)
    for i in range(cfg.n_layers):
        p_l = jax.tree.map(lambda a, i=i: a[i], params["layers"])
        x, a = jt.layer_fwd(cfg, p_l, x, positions)
        aux = aux + a
    x = jl.apply_norm(cfg, params["final_norm"], x)
    loss = jl.lm_loss_from_features(params["embed"], x[:, :-1],
                                    batch["tokens"][:, 1:],
                                    batch.get("mask"))
    return loss + jt.AUX_WEIGHT * aux


@pytest.fixture(scope="module", params=[MOE, DENSE])
def lm_case(request):
    """The reference's loss and ``jax.grad`` on its smoke config (MoE on
    its Pallas grouped matmul, interpret mode, through
    :func:`_jax_loss_unscanned`; dense through ``get_model(cfg).loss``),
    the parameters and the batch."""
    name = request.param
    jcfg = jsmoke(JARCHS[name])
    japi = jget_model(jcfg)
    loss_fn = japi.loss
    if jcfg.family == "moe":
        jcfg = jcfg.scaled(moe_pallas_dispatch=True)
        loss_fn = lambda p, b: _jax_loss_unscanned(jcfg, p, b)  # noqa: E731
    jp = japi.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    mask = (np.random.default_rng(2).random((4, 31)) < 0.8).astype(
        np.float32)
    out = {}
    for label, batch in (("plain", {"tokens": tokens}),
                         ("masked", {"tokens": tokens, "mask": mask})):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp, jb)
        out[label] = (batch, float(loss), grads)
    return name, jcfg, jp, out


@pytest.mark.parametrize("label", ["plain", "masked"])
def test_loss_and_gradients_match_reference(lm_case, label):
    name, jcfg, jp, out = lm_case
    batch, jloss, jgrads = out[label]
    cfg = smoke_config(ARCHS[name])
    assert cfg.moe_kernel_dispatch
    params = params_from_jax(cfg, jp, device="cpu")
    loss, grads = _grads(get_model(cfg), params,
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    want = params_from_jax(cfg, jgrads, device="cpu")
    for (path, w), g in zip(tree_leaves_with_path(want), grads):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        err = _rel_l2(g.numpy(), w.numpy())
        assert err <= GRAD_REL_L2, (path, err)


def test_moe_loss_einsum_path_matches_kernel_path():
    """The port's two MoE paths give the same loss and gradients (the
    einsum path is what the card checks the kernel path against)."""
    cfg = smoke_config(ARCHS[MOE])
    params = get_model(cfg).init(torch.Generator().manual_seed(3),
                                 device="cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32))}
    res = [_grads(get_model(c), params, batch)
           for c in (cfg, cfg.scaled(moe_kernel_dispatch=False))]
    (lk, gk), (le, ge) = res
    assert abs(float(lk) - float(le)) <= LOSS_RTOL * abs(float(le))
    for a, b in zip(gk, ge):
        assert _rel_l2(a.numpy(), b.numpy()) <= GRAD_REL_L2


def test_loss_functions_match_reference():
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = np.array([[1, 1, 0, 1, 0], [0, 0, 0, 0, 0]], np.float32)
    table = rng.normal(size=(11, 6)).astype(np.float32)
    x = rng.normal(size=(2, 5, 6)).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        want = float(jlayers.cross_entropy_loss(jnp.asarray(logits),
                                                jnp.asarray(labels), jm))
        got = float(tlayers.cross_entropy_loss(torch.from_numpy(logits),
                                               torch.from_numpy(labels), tm))
        assert got == pytest.approx(want, rel=LOSS_RTOL, abs=1e-7)
        want = float(jlayers.lm_loss_from_features(
            jnp.asarray(table), jnp.asarray(x), jnp.asarray(labels), jm))
        got = float(tlayers.lm_loss_from_features(
            torch.from_numpy(table), torch.from_numpy(x),
            torch.from_numpy(labels), tm))
        assert got == pytest.approx(want, rel=LOSS_RTOL, abs=1e-7)
    from repro.models import transformer as jtransformer

    assert AUX_WEIGHT == jtransformer.AUX_WEIGHT


# ----------------------------------------------------------- optimizer


def _opt_trees(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(6, 5)).astype(dtype),
              "layers": {"b": rng.normal(size=(7,)).astype(dtype)}}
    grads = [{"w": rng.normal(size=(6, 5)).astype(np.float32) * s,
              "layers": {"b": rng.normal(size=(7,)).astype(np.float32) * s}}
             for s in (3.0, 0.1, 2.0)]
    return params, grads


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0),
    dict(lr="cosine", weight_decay=0.0, clip_norm=None),
    dict(lr="constant", weight_decay=0.3, clip_norm=0.5, b2=0.99),
])
def test_adamw_matches_reference(kw):
    params, grads = _opt_trees()
    lr = kw.pop("lr")
    jlr = {"cosine": jopt.cosine_schedule(3e-2, warmup=2, total=5),
           "constant": jopt.constant_schedule(2e-2)}.get(lr, lr)
    tlr = {"cosine": topt.cosine_schedule(3e-2, warmup=2, total=5),
           "constant": topt.constant_schedule(2e-2)}.get(lr, lr)
    jo, to = jopt.AdamW(lr=jlr, **kw), topt.AdamW(lr=tlr, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {"w": torch.from_numpy(params["w"].copy()),
          "layers": {"b": torch.from_numpy(params["layers"]["b"].copy())}}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js, jn = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tg = {"w": torch.from_numpy(g["w"]),
              "layers": {"b": torch.from_numpy(g["layers"]["b"])}}
        tp, ts, tn = to.update(tg, ts, tp)
        assert float(tn) == pytest.approx(float(jn), rel=OPT_RTOL)
    assert int(ts.step) == int(js.step) == 3
    for t, j in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for a, b in ((t["w"], j["w"]), (t["layers"]["b"], j["layers"]["b"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=OPT_RTOL, atol=OPT_ATOL)


def test_adamw_keeps_bf16_params_and_f32_moments():
    params, grads = _opt_trees(seed=1)
    o = topt.AdamW(lr=1e-2)
    tp = {"w": torch.from_numpy(params["w"]).bfloat16()}
    jp = {"w": jnp.asarray(params["w"], jnp.bfloat16)}
    ts, js = o.init(tp), jopt.AdamW(lr=1e-2).init(jp)
    g = grads[0]["w"]
    tp, ts, _ = o.update({"w": torch.from_numpy(g).bfloat16()}, ts, tp)
    jp, js, _ = jopt.AdamW(lr=1e-2).update(
        {"w": jnp.asarray(g, jnp.bfloat16)}, js, jp)
    assert tp["w"].dtype == torch.bfloat16
    assert ts.mu["w"].dtype == torch.float32
    np.testing.assert_array_equal(tp["w"].float().numpy(),
                                  np.asarray(jp["w"], np.float32))


def test_adamw_update_in_stretches_is_the_whole_leaf_update(monkeypatch):
    """``update`` cuts a leaf into stretches of UPDATE_CHUNK elements (to
    bound its f32 temporaries); the update is elementwise, so any cut
    gives the same bits as the whole leaf, bf16 leaves, a scalar and a
    leaf shorter than a stretch included."""
    rng = np.random.default_rng(3)
    params = {"w": torch.from_numpy(rng.standard_normal((7, 13)).astype(
                  np.float32)).to(torch.bfloat16),
              "b": torch.from_numpy(rng.standard_normal(5).astype(
                  np.float32)),
              "s": torch.tensor(0.5)}
    grads = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)).to(v.dtype) for k, v in params.items()}
    o = topt.AdamW(lr=1e-2)
    out = {}
    for chunk in (1 << 26, 8):
        monkeypatch.setattr(topt, "UPDATE_CHUNK", chunk)
        p = {k: v.clone() for k, v in params.items()}
        st = o.init(p)
        for _ in range(2):
            p, st, _ = o.update(grads, st, p)
        out[chunk] = (p, st)
    (pa, sa), (pb, sb) = out[1 << 26], out[8]
    for k in params:
        for a, b in ((pa[k], pb[k]), (sa.mu[k], sb.mu[k]),
                     (sa.nu[k], sb.nu[k])):
            assert torch.equal(a, b), k


def test_adamw_converges_quadratic():
    o = topt.AdamW(lr=0.1, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = o.init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        params, state, _ = o.update({"w": 2 * (params["w"] - target)},
                                    state, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_grad_clipping_and_global_norm():
    o = topt.AdamW(lr=0.0, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    _, _, gnorm = o.update({"w": torch.tensor([3.0, 4.0, 0.0])},
                           o.init(params), params)
    assert abs(float(gnorm) - 5.0) < 1e-5
    assert float(topt.global_norm({"a": torch.tensor([3.0]),
                                   "b": [torch.tensor([4.0])]})) == \
        pytest.approx(5.0)
    tree = _opt_trees(seed=2)[1][0]
    assert float(topt.global_norm(
        {k: torch.from_numpy(np.asarray(v)) if not isinstance(v, dict)
         else {"b": torch.from_numpy(v["b"])} for k, v in tree.items()})) \
        == pytest.approx(float(jopt.global_norm(tree)), rel=OPT_RTOL)


def test_schedules_match_reference():
    tc = topt.cosine_schedule(1e-3, warmup=10, total=100)
    jc = jopt.cosine_schedule(1e-3, warmup=10, total=100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = float(tc(torch.tensor(s, dtype=torch.int32)))
        want = float(jc(jnp.asarray(s, jnp.int32)))
        assert got == pytest.approx(want, rel=OPT_RTOL, abs=1e-12), s
    assert float(tc(torch.tensor(0))) == 0.0
    assert abs(float(tc(torch.tensor(10))) - 1e-3) < 1e-9
    assert float(tc(torch.tensor(100))) < 2e-4
    assert float(topt.constant_schedule(3e-3)(torch.tensor(7))) == \
        pytest.approx(3e-3)


# ---------------------------------------------------------- compression


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_grad_compression_roundtrip_matches_reference(method):
    a = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    a *= np.float32(0.01)
    c = np.full((4, 4), 2.5, np.float32)
    got = decompress_tree(compress_tree(
        {"a": torch.from_numpy(a), "b": {"c": torch.from_numpy(c)}}, method))
    want = jcoll.decompress_tree(jcoll.compress_tree(
        {"a": jnp.asarray(a), "b": {"c": jnp.asarray(c)}}, method))
    tol = 1e-2 if method == "bf16" else 5e-2
    np.testing.assert_allclose(got["a"].numpy(), a, rtol=tol, atol=tol * 0.01)
    for g, w in ((got["a"], want["a"]), (got["b"]["c"], want["b"]["c"])):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
    with pytest.raises(ValueError, match="unknown compression"):
        compress_tree({"a": torch.from_numpy(a)}, "fp4")


def test_int8_codes_match_reference():
    g = np.random.default_rng(5).normal(size=(33,)).astype(np.float32)
    q, s = compress_tree([torch.from_numpy(g)], "int8")["data"][0]
    jq, js = jcoll.compress_tree([jnp.asarray(g)], "int8")["data"][0]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


# ----------------------------------------------------------- checkpoint


def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "h": torch.arange(6.0).reshape(2, 3).bfloat16()},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    from repro_torch.core.tree import tree_map

    return tree_map(torch.zeros_like, tree)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    tree = _tree()
    mgr.save(100, tree)
    restored, step = mgr.restore(_zeros_like(tree))
    assert step == 100
    for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(restored["step"]) == 7


def test_checkpoint_async_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    mgr.wait()
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_integrity_detection(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(5, _tree())
    victim = next((tmp_path / "step_00000005").glob("arr_*.npy"))
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(_tree())


def test_checkpoint_restore_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    t = _tree()
    mgr.save(1, t)
    from repro_torch.core.tree import tree_map

    mgr.save(9, tree_map(lambda x: x + 1, t))
    restored, step = mgr.restore(t)
    assert step == 9
    assert int(restored["step"]) == 8


def test_checkpoint_layout_matches_reference(tmp_path):
    """The same directory layout and manifest fields as the reference's;
    leaves keyed by their path in the port's tree (a list's index)."""
    ours = CheckpointManager(tmp_path / "t", async_save=False)
    ours.save(3, {"layers": [{"w": torch.ones(2)}], "step": torch.tensor(1)})
    theirs = JCheckpointManager(tmp_path / "j", async_save=False)
    theirs.save(3, {"layers": [{"w": jnp.ones(2)}], "step": jnp.asarray(1)})
    import json

    read = [json.loads((tmp_path / d / "step_00000003" / "manifest.json")
                       .read_text()) for d in ("t", "j")]
    assert [sorted(r["key"] for r in m["leaves"]) for m in read] == [
        ["layers/0/w", "step"]] * 2
    assert set(read[0]["leaves"][0]) == set(read[1]["leaves"][0])


# ------------------------------------------------------- fault tolerance


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_heartbeat_dead_host():
    clk = FakeClock()
    mon = tft.HeartbeatMonitor(["h0", "h1"], timeout_s=10, clock=clk)
    mon.beat("h0", 1.0)
    mon.beat("h1", 1.0)
    clk.t = 5.0
    assert mon.dead_hosts() == []
    clk.t = 11.0
    mon.beat("h0", 1.0)
    assert mon.dead_hosts() == ["h1"]


def test_straggler_detection_matches_reference():
    seen = []
    for mod in (tft, jft):
        clk = FakeClock()
        mon = mod.HeartbeatMonitor(["h0", "h1", "h2"], straggler_factor=1.5,
                                   patience=3, clock=clk)
        polls = []
        for _ in range(5):
            clk.t += 1
            mon.beat("h0", 1.0)
            mon.beat("h1", 1.0)
            mon.beat("h2", 3.0)
            polls.append({h: (s.alive, s.straggler, s.p50_ratio)
                          for h, s in mon.poll().items()})
        seen.append((polls, mon.stragglers()))
    assert seen[0] == seen[1]
    assert seen[0][1] == ["h2"]


def test_plan_remesh_and_elastic_match_reference():
    for n in (1, 4, 100, 128, 257):
        for mp in (1, 2, 16):
            if n * 4 < mp:
                continue
            assert tft.plan_remesh(n, 4, mp) == jft.plan_remesh(n, 4, mp)
    assert tft.plan_remesh(128, 4, 16) == (32, 16)
    assert tft.plan_remesh(100, 4, 16) == (16, 16)
    clk = FakeClock()
    mon = tft.HeartbeatMonitor(["h0", "h1"], timeout_s=10, clock=clk)
    mon.beat("h0", 1.0)
    clk.t = 20.0
    mon.beat("h0", 1.0)
    plan = tft.make_elastic_plan(mon, [100, 200], global_batch=256,
                                 chips_per_host=4, model_parallel=2)
    assert plan.restore_step == 200
    assert plan.mesh_shape == (2, 2)
    assert plan.global_batch == 256
    assert "h1" in plan.note


def test_no_plan_when_healthy():
    mon = tft.HeartbeatMonitor(["h0"], clock=time.monotonic)
    mon.beat("h0", 1.0)
    assert tft.make_elastic_plan(mon, [1], global_batch=8) is None


# ----------------------------------------------------------------- data


@pytest.mark.parametrize("host", [(0, 1), (0, 2), (1, 2)])
def test_token_stream_equals_reference_bit_for_bit(host):
    kw = dict(host_index=host[0], host_count=host[1], seed=3)
    a, b = ShardedTokenStream(100, 16, 8, **kw), JStream(100, 16, 8, **kw)
    for _ in range(3):
        x, y = next(a)["tokens"], next(b)["tokens"]
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)
    st = a.state()
    x = next(a)
    a2 = ShardedTokenStream(100, 16, 8, **kw)
    a2.restore(st)
    np.testing.assert_array_equal(next(a2)["tokens"], x["tokens"])


def test_sharded_stream_disjoint():
    a = ShardedTokenStream(100, 16, 8, host_index=0, host_count=2, seed=3)
    b = ShardedTokenStream(100, 16, 8, host_index=1, host_count=2, seed=3)
    ba, bb = next(a), next(b)
    assert ba["tokens"].shape == (4, 16)
    assert not np.array_equal(ba["tokens"], bb["tokens"])


# -------------------------------------------------------------- trainer

TRAIN_CASES = {"full": {}, "microbatches 2": {"microbatches": 2},
               "int8": {"grad_compression": "int8"}}


@pytest.fixture(scope="module")
def jax_trainer_losses(tmp_path_factory):
    """The reference's Trainer over 5 steps of the smoke qwen2-7b at
    constant lr 1e-3, weight decay 0, on the token stream, per case."""
    cfg = jsmoke(JARCHS[DENSE])
    api = jget_model(cfg)
    out = {}
    for label, kw in TRAIN_CASES.items():
        tr = _one_host(JTrainer(
            api, jopt.AdamW(lr=jopt.constant_schedule(1e-3),
                            weight_decay=0.0),
            iter(JStream(cfg.vocab_size, 32, 8, seed=0)),
            ckpt_dir=tmp_path_factory.mktemp("jax_ckpt"),
            tcfg=JTrainerConfig(total_steps=5, ckpt_every=100,
                                log_every=100, **kw)))
        tr.run(tr.init_or_restore(jax.random.PRNGKey(0)))
        out[label] = tr.losses()
    return out, api.init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("label", list(TRAIN_CASES))
def test_trainer_losses_match_reference(jax_trainer_losses, label,
                                        tmp_path):
    want, jparams = jax_trainer_losses
    cfg = smoke_config(ARCHS[DENSE])
    api = get_model(cfg)
    opt = topt.AdamW(lr=topt.constant_schedule(1e-3), weight_decay=0.0)
    tr = _one_host(Trainer(
        api, opt, iter(ShardedTokenStream(cfg.vocab_size, 32, 8, seed=0)),
        ckpt_dir=tmp_path,
        tcfg=TrainerConfig(total_steps=5, ckpt_every=100, log_every=100,
                           **TRAIN_CASES[label]),
        device="cpu"))
    params = params_from_jax(cfg, jparams, device="cpu")
    tr.run(TrainState(params=params, opt=opt.init(params)))
    np.testing.assert_allclose(tr.losses(), want[label], rtol=TRAINER_RTOL)


def test_checkpoint_restart_continuity(tmp_path):
    cfg = smoke_config(ARCHS[DENSE])
    api = get_model(cfg)
    opt = topt.AdamW(lr=topt.constant_schedule(1e-3), weight_decay=0.0)

    def trainer(steps):
        return _one_host(Trainer(
            api, opt, iter(ShardedTokenStream(cfg.vocab_size, 32, 8,
                                              seed=0)),
            ckpt_dir=tmp_path,
            tcfg=TrainerConfig(total_steps=steps, ckpt_every=5,
                               log_every=100), device="cpu"))

    tr = trainer(10)
    state = tr.run(tr.init_or_restore(torch.Generator().manual_seed(0)))
    assert tr.ckpt.all_steps() == [5, 10]
    tr2 = trainer(12)
    state2 = tr2.init_or_restore(torch.Generator().manual_seed(1))
    assert int(state2.opt.step) == 10
    for a, b in zip(tree_leaves(state2), tree_leaves(state)):
        assert torch.equal(a, b)
    state2 = tr2.run(state2)
    assert int(state2.opt.step) == 12
    assert np.isfinite(tr2.losses()).all()


def test_microbatch_step_equals_full_batch_step():
    cfg = smoke_config(ARCHS[DENSE])
    api = get_model(cfg)
    opt = topt.AdamW(lr=topt.constant_schedule(1e-3), weight_decay=0.0,
                     clip_norm=None)
    batch = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32)}
    ws = []
    for mb in (1, 2):
        state = init_state(api, opt, torch.Generator().manual_seed(0),
                           device="cpu")
        state, metrics = make_train_step(api, opt, microbatches=mb)(state,
                                                                    batch)
        assert int(metrics["step"]) == 1
        ws.append(tree_leaves(state.params)[0].numpy())
    np.testing.assert_allclose(ws[0], ws[1], rtol=5e-4, atol=5e-5)


def test_launcher_trains_on_the_cpu(tmp_path):
    from repro_torch.launch import train

    tr = train.main(["--arch", MOE, "--steps", "4", "--seq", "16",
                     "--batch", "4", "--ckpt-every", "2", "--ckpt-dir",
                     str(tmp_path), "--device", "cpu"])
    assert tr.ckpt.all_steps() == [2, 4]
    assert np.isfinite(tr.losses()).all() and len(tr.losses()) == 4


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config(ARCHS[DENSE])
    api = get_model(cfg)
    opt = topt.AdamW()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(api, opt, iter([]), ckpt_dir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(api, opt, torch.Generator())
