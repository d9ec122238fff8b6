"""Attention (port of ``repro/models/attention.py``): graph attention over
a sparse pattern on the fused kernels, and the LM's dense GQA attention.

Layout as in the reference: q (B, Sq, H, Dh), k and v (B, Skv, KH, Dh)
with H = KH * G; query head ``h`` reads kv head ``h // G``.
``flash_attention`` is plain jnp in the reference (a chunked online
softmax in f32, no Pallas), so the port computes the same function with
``scaled_dot_product_attention`` on f32 operands (on ``meta``, the
memory-efficient op it runs on the card: ``_sdpa``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed import collectives as coll
from ..kernels.fused_attention import NEG_INF
from ..sparse.ops import sparse_attention


def graph_attention(adj, q, k, v, *, schedule=None, scale=None,
                    device=None):
    """Sparse (graph) attention over an adjacency pattern through the
    fused SDDMM -> softmax -> SpMM kernels, fused in both directions
    (:func:`repro_torch.sparse.sparse_attention`).

    Single-head: q (n_rows, d), k/v (n_cols, d/dv).  Multi-head: q
    (n_rows, H, d) with k/v (n_cols, H, ·); the heads share the pattern
    and run in one kernel launch.  A CSR adjacency's stored values act
    as an additive score bias.
    """
    return sparse_attention(adj, q, k, v, schedule=schedule, scale=scale,
                            device=device)


def _heads_first(t, groups: int = 1):
    """(B, S, K, Dh) -> (B, K * groups, S, Dh) in f32, each head repeated
    ``groups`` times in place (the GQA mapping h -> h // groups)."""
    t = t.to(torch.float32).transpose(1, 2)
    return t.repeat_interleave(groups, dim=1) if groups > 1 else t


def flash_attention(q, k, v, causal: bool = True):
    """Softmax attention with GQA, computed in f32 and cast to q's type.
    The causal mask keeps key positions ``<=`` the query's (both counted
    from 0)."""
    g = q.shape[2] // k.shape[2]
    o = _sdpa(_heads_first(q), _heads_first(k, g), _heads_first(v, g),
              causal)
    return o.transpose(1, 2).to(q.dtype)


def _sdpa(q, k, v, causal):
    """``scaled_dot_product_attention`` on (B, H, S, Dh) operands.  On
    ``meta``, which stands for the card in the dry run, it runs the op
    that ``scaled_dot_product_attention`` runs on the card for f32
    operands, the memory-efficient attention, with the log-sum-exp kept
    where autograd needs it, as there (on ``meta`` PyTorch would run its
    math path, which writes the (S, S) scores)."""
    if q.device.type != "meta":
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    lse = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return torch.ops.aten._scaled_dot_product_efficient_attention(
        q, k, v, None, lse, is_causal=causal)[0]


def attention_ref(q, k, v, causal=True):
    """Naive reference for tests: the full score matrix in f32."""
    b, sq, h, dh = q.shape
    kh = k.shape[2]
    qi = q.reshape(b, sq, kh, h // kh, dh).to(torch.float32)
    s = torch.einsum("bqkgd,bckd->bkgqc", qi, k.to(torch.float32)) \
        * dh ** -0.5
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(k.shape[1], device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v.to(torch.float32))
    return o.reshape(b, sq, h, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos: int, axis=None):
    """One decode token.  q (B, H, Dh); caches (B, S, KH, Dh); cache
    entries at index ``<= pos`` are valid.  Scores in f32; the
    probabilities are cast to the cache's type before the product with V,
    as in the reference, which accumulates that product in f32.

    Over ``axis`` the caches are the rank's block of the sequence
    (positions ``axis.index * S`` on), and the function is what XLA's
    partitioner makes of the reference's over a sequence-sharded cache:
    the local scores masked beyond ``pos``, a ``pmax`` of the row max, a
    ``psum`` of the sum of exponentials, the probabilities normalised and
    cast locally, the local P V in f32 and a ``psum``.  A rank whose
    positions all lie beyond ``pos`` adds exponentials of ``NEG_INF``
    less the global max, zeros."""
    b, s, kh, dh = k_cache.shape
    qi = q.reshape(b, kh, q.shape[1] // kh, dh).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qi,
                          k_cache.to(torch.float32)) * dh ** -0.5
    first = 0 if axis is None else axis.index * s
    valid = torch.arange(first, first + s, device=q.device) <= pos
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    if axis is None:
        p = torch.softmax(scores, dim=-1)
    else:
        m = coll.pmax(scores.amax(dim=-1, keepdim=True), axis)
        e = torch.exp(scores - m)
        p = e / coll.psum(e.sum(dim=-1, keepdim=True), axis)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).to(torch.float32),
                     v_cache.to(torch.float32))
    if axis is not None:
        o = coll.psum(o, axis)
    return o.reshape(b, q.shape[1], dh).to(q.dtype)
