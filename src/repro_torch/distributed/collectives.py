"""Gradient compression (port of ``compress_tree`` and
``decompress_tree`` of ``repro/distributed/collectives.py``): a gradient
tree quantized before a data-parallel all-reduce would move it, bf16
(2x fewer bytes than f32) or int8 with one f32 scale a tensor (4x).  The
all-reduce itself is not ported yet (ROADMAP.md, queue 1 item 5)."""
from __future__ import annotations

import torch

from ..core.tree import tree_map


def compress_tree(grads, method: str):
    if method == "bf16":
        return {"m": "bf16",
                "data": tree_map(lambda g: g.to(torch.bfloat16), grads)}
    if method == "int8":
        def q(g):
            g = g.to(torch.float32)
            scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
            return (torch.clamp(torch.round(g / scale), -127, 127)
                    .to(torch.int8), scale)
        return {"m": "int8", "data": tree_map(q, grads)}
    raise ValueError(f"unknown compression {method!r}")


def decompress_tree(packed):
    if packed["m"] == "bf16":
        return tree_map(lambda g: g.to(torch.float32), packed["data"])
    if packed["m"] == "int8":
        return tree_map(lambda qs: qs[0].to(torch.float32) * qs[1],
                        packed["data"],
                        is_leaf=lambda x: isinstance(x, tuple)
                        and not hasattr(x, "_fields"))
    raise ValueError(f"unknown compression {packed['m']!r}")
