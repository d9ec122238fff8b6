"""Layers (port of ``repro/models/layers.py``): the sparse GCN layers
``gcn_layer`` and ``gcn_two_layer``, and the LM half (norms, dense,
rotary embedding, MLP, embedding) that ``models/transformer.py`` runs."""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..core.schedule import Epilogue, torch_dtype
from ..distributed import collectives as coll
from ..fuse import gcn_chain, run_plan
from ..fuse import plan as plan_chain
from ..sparse.ops import spmm


def gcn_layer(adj, x, w, b=None, *, activation="relu", residual=None,
              schedule="auto", device=None):
    """One GCN layer, fused: ``act(Ã (x @ w) + b) [+ residual]`` as one
    scheduled SpMM with its epilogue.  The dense ``x @ w`` stays
    ``torch.matmul``, as the reference leaves it to XLA.  Differentiable
    in x, w, b, residual and a CSR ``adj``'s values through ``spmm``'s
    backward."""
    ep = Epilogue(activation=activation, bias=b is not None,
                  residual=residual is not None)
    return spmm(adj, x @ w, schedule=schedule, bias=b, residual=residual,
                epilogue=ep, device=device)


def gcn_two_layer(adj, x, w0, w1, b0=None, b1=None, *, activation="relu",
                  final_activation=None, schedule=None, plan=None,
                  device=None):
    """Two-layer GCN, ``Ã act(Ã (x @ w0) + b0) @ w1 [+ b1]``, built as a
    ``repro_torch.fuse`` chain and run by the fusion planner: the
    activations and biases fold into their producing SpMM's epilogue, so
    the model is 2 planned launches (on an EB schedule each SpMM with an
    epilogue runs it as a second CUDA kernel; RB fuses it in its store).

    ``plan`` overrides the greedy plan (e.g. a
    :func:`repro_torch.fuse.tuned_plan` replay, or an explicit split for
    A/B timing); ``schedule`` rides on both SpMM anchors (None:
    per-matrix 'auto' selection).  ``device`` as for ``spmm``: None
    means 'cuda'.
    Differentiable in x, the weights and biases (and a CSR ``adj``'s
    values) through ``spmm``'s backward."""
    chain, params = gcn_chain(adj, (w0, w1), (b0, b1),
                              activation=activation,
                              final_activation=final_activation,
                              schedule=schedule)
    return run_plan(plan_chain(chain) if plan is None else plan, x, params,
                    device=device)


# ---------------------------------------------------------------------------
# The LM half (port of the norms, dense, rope, mlp and embedding of
# ``repro/models/layers.py``).  Parameters are plain dicts of tensors; an
# ``init_*`` function draws them from ``gen``, a ``torch.Generator`` on
# the device the tensors are made on (or a ``ShapeOnly`` on meta).
# ``layer_scan``, ``seq_shard`` and ``seq_unshard`` have no counterpart:
# layers run in a Python loop, and Megatron-SP is not ported.  Under a
# tensor-parallel split (``axis``, a ``launch.mesh.MeshAxis`` the weights
# are split over) the MLP, the embedding and the loss compute the
# reference's function from the rank's blocks (Megatron's f and g,
# ``distributed/collectives.py``); ``axis=None`` is the whole leaf.
# ---------------------------------------------------------------------------


def remat(cfg, fn, *args):
    """``fn(*args)``, one layer; under ``cfg.remat`` while autograd
    records, recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant), so that nothing inside the layer but its inputs is
    held: the reference's ``jax.checkpoint(..., policy=
    nothing_saveable)``.  The layer draws no random numbers, so no RNG
    state is kept; every collective inside it runs again, in the same
    order on every rank."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


class ShapeOnly:
    """What the ``init_*`` functions draw from where an init is asked for
    on ``device="meta"`` (``transformer.draw_source``): its ``device`` is
    meta, so every leaf is made there, and :func:`init_normal` makes an
    empty tensor of the leaf's shape and type, drawing nothing.  A shape
    tree of any size takes no memory (the port's counterpart of
    ``jax.eval_shape(api.init, key)``)."""

    device = torch.device("meta")


def init_normal(gen, shape, scale, dtype):
    """``normal(shape) * scale`` drawn in f32 and cast, as the reference's
    ``(jax.random.normal(k, shape) * scale).astype(dtype)``; from a
    :class:`ShapeOnly` the empty meta tensor of that shape and type."""
    if isinstance(gen, ShapeOnly):
        return torch.empty(shape, dtype=torch_dtype(dtype), device=gen.device)
    t = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return t.mul_(scale).to(torch_dtype(dtype))


def rmsnorm(x, scale, eps: float = 1e-6, axis=None):
    """RMS norm in f32, scaled by ``1 + scale``, cast back to x's type.
    Over ``axis`` (x the rank's equal block of the normed dim, ``scale``
    its block) the sum of squares is a ``psum`` (its cotangent too, each
    rank holding a part of it)."""
    xf = x.to(torch.float32)
    if axis is None or axis.size == 1:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    else:
        ss = coll.copy_to(coll.reduce_from(
            (xf * xf).sum(dim=-1, keepdim=True), axis), axis)
        var = ss / (xf.shape[-1] * axis.size)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    """Layer norm in f32 with scale and bias, cast back to x's type."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def init_norm(cfg, d, device):
    dt = torch_dtype(cfg.param_dtype)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros(d, dtype=dt, device=device)}
    return {"scale": torch.ones(d, dtype=dt, device=device),
            "bias": torch.zeros(d, dtype=dt, device=device)}


def apply_norm(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def dense(x, w, b=None):
    """``x @ w (+ b)`` in x's type (f32 accumulation inside the product)."""
    y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def init_dense(gen, d_in, d_out, dtype, bias=False, scale=None):
    if scale is None:
        scale = d_in ** -0.5
    p = {"w": init_normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=torch_dtype(dtype),
                             device=gen.device)
    return p


def apply_dense(p, x):
    return dense(x, p["w"], p.get("b"))


def rope_freqs(dh: int, theta: float, device=None):
    return theta ** (-torch.arange(0, dh, 2, dtype=torch.float32,
                                   device=device) / dh)


def apply_rope(x, positions, theta: float = 1e4):
    """Rotary embedding over the halves of the head dim (``x1``, ``x2``
    rotate as one complex pair), angles in f32.  x (B, S, H, Dh);
    positions (S,) or (B, S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(cfg, gen, d_model=None, d_ff=None):
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    p = {"wi": init_dense(gen, d, f, dt)["w"]}
    if cfg.mlp_type == "swiglu":
        p["wg"] = init_dense(gen, d, f, dt)["w"]
    p["wo"] = init_dense(gen, f, d, dt, scale=f ** -0.5)["w"]
    return p


def apply_mlp(cfg, p, x, axis=None):
    """The MLP; over ``axis`` (``wi``/``wg`` the rank's column block,
    ``wo`` its row block) the tensor-parallel one: ``x`` enters through
    ``copy_to`` and the partial products leave through ``reduce_from``,
    each model rank computing its share of F."""
    if axis is not None:
        x = coll.copy_to(x, axis)
    if cfg.mlp_type == "swiglu":
        h = F.silu(dense(x, p["wg"])) * dense(x, p["wi"])
    else:
        h = F.gelu(dense(x, p["wi"]), approximate="tanh")  # jax.nn.gelu
    y = dense(h, p["wo"])
    return y if axis is None else coll.reduce_from(y, axis)


def init_embedding(gen, vocab, d, dtype):
    return init_normal(gen, (vocab, d), 0.02, dtype)


def _vocab_block(table, ids, axis):
    """(the ids' rows of the rank's vocabulary block ``table``, each at
    its row where the id lies in the block and row 0 elsewhere, the mask
    of those in it)."""
    n = table.shape[0]
    local = ids.long() - axis.index * n
    inside = (local >= 0) & (local < n)
    return table[torch.where(inside, local, 0)], inside


def embed(table, tokens, axis=None):
    """The tokens' rows of the embedding; over ``axis`` (``table`` the
    rank's vocabulary block) each rank looks up the ids in its block,
    zeros elsewhere, and a ``reduce_from`` sums the blocks' rows: the
    same bits, since every other term is zero."""
    if axis is None:
        return table[tokens.long()]
    rows, inside = _vocab_block(table, tokens, axis)
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return coll.reduce_from(rows, axis)


def unembed(table, x, axis=None):
    """Logits against the tied embedding, in x's type; over ``axis`` the
    whole vocabulary's, gathered from the blocks' (``gather_from``), as
    the reference's global array reads."""
    if axis is None:
        return x @ table.t()
    return coll.gather_from(coll.copy_to(x, axis) @ table.t(), axis, -1)


def cross_entropy_loss(logits, labels, mask=None):
    """Mean token NLL; logits (..., V) upcast to f32, labels int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return _masked_mean(logz - gold, mask)


def _masked_mean(nll, mask):
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def lm_loss_from_features(table, x, labels, mask=None, axis=None):
    """The LM loss from final features, as the reference computes it: the
    log-partition over the tied embedding's logits (in x's type, upcast to
    f32), and the gold logit as ``<x, E[label]>`` in f32, a gather of the
    label's row of the table rather than of the logits' column.

    Over ``axis`` (``table`` the rank's vocabulary block) the logits stay
    in blocks: the log-partition is ``m + log(s)`` with ``m`` the
    ``pmax`` of the blocks' row maxima (no gradient through it) and
    ``s`` the ``psum`` of their sums of ``exp(logit - m)``, and the gold
    logit the ``psum`` of the term the rank holding the label computes
    (zero elsewhere); ``x`` enters through ``copy_to``."""
    if axis is None:
        logits = unembed(table, x).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)  # (B, S)
        gold_emb = embed(table, labels)  # (B, S, D)
        gold = (x.to(torch.float32) * gold_emb.to(torch.float32)).sum(-1)
        return _masked_mean(logz - gold, mask)
    x = coll.copy_to(x, axis)
    logits = (x @ table.t()).to(torch.float32)
    m = coll.pmax(logits.detach().amax(dim=-1), axis)
    s = coll.reduce_from(torch.exp(logits - m[..., None]).sum(-1), axis)
    logz = m + torch.log(s)
    rows, inside = _vocab_block(table, labels, axis)
    gold = (x.to(torch.float32) * rows.to(torch.float32)).sum(-1)
    gold = coll.reduce_from(torch.where(inside, gold,
                                        torch.zeros_like(gold)), axis)
    return _masked_mean(logz - gold, mask)
