"""How the one-rank Qwen3-MoE of chip_smoke.py's moe_serve phase (full
width, 4 layers, random weights from its seed) answers an f32 reordering
of its MoE combine: the no-drop prefill of 4 of the phase's prompts and
3 decode steps run twice as they are, then with each layer's combine
summed as 2 and as 4 partials over blocks of experts (the
expert-parallel ranks' arithmetic), each fed the first run's tokens and
held against it: logits relative L2, bit for bit, greedy tokens, and the
tokens whose top-8 experts differ in each MoE call.  Needs one GPU.

    python3 probes/moe_combine_order.py
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # the repository
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

print(cs.card_line(), flush=True)
build.build()
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
with torch.no_grad():
    cfg, api, einsum, params = cs.moe_model(dev)
    nd = get_model(cfg.scaled(capacity_factor=16.0))
    tokens = torch.as_tensor(np.stack(cs.moe_prompts(cfg)[:4]),
                             dtype=torch.int64, device=dev)
    routes = []
    orig_route, orig_ffn = tmoe._route, tmoe._expert_ffn

    def rec_route(cfg_, x, router):
        g, p = orig_route(cfg_, x, router)
        routes.append((g > 0).cpu())
        return g, p

    tmoe._route = rec_route

    def run(nexts=None):
        routes.clear()
        lg, cache = nd.prefill(params, {"tokens": tokens}, 160)
        out, toks = [lg.float()], [lg.argmax(-1)]
        for i in range(3):
            t = toks[-1] if nexts is None else nexts[i]
            lg, cache = nd.decode_step(params, cache, t)
            out.append(lg.float())
            toks.append(lg.argmax(-1))
        return out, toks, list(routes)

    def split(m):
        def ffn(cfg_, x, wg, wi, wo, gates, cap, use, dispatch=None,
                combine="sum"):
            e = wg.shape[0] // m
            parts = [orig_ffn(cfg_, x, wg[i * e:(i + 1) * e],
                              wi[i * e:(i + 1) * e], wo[i * e:(i + 1) * e],
                              gates[:, i * e:(i + 1) * e], cap, use,
                              dispatch) for i in range(m)]
            tot = parts[0]
            for p in parts[1:]:
                tot = tot + p
            return tot
        return ffn

    a, ta, ra = run()
    for label, fn in (("again", orig_ffn), ("split 2", split(2)),
                      ("split 4", split(4))):
        tmoe._expert_ffn = fn
        b, tb, rb = run(ta)
        tmoe._expert_ffn = orig_ffn
        errs = [cs.rel_l2(x, y) for x, y in zip(b, a)]
        same = [bool(torch.equal(x, y)) for x, y in zip(tb, ta)]
        flips = [int((x != y).any(-1).sum()) for x, y in zip(rb, ra)]
        bits = [bool(torch.equal(x, y)) for x, y in zip(b, a)]
        print(f"{label}: logits rel L2 {['%.3e' % e for e in errs]}, "
              f"bitwise equal {bits}, greedy tokens equal {same}; tokens "
              f"with another top-8 per MoE call {flips}", flush=True)
print("EP_DIAG DONE", flush=True)
