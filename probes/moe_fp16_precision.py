"""Where the fp16 MoE layer's two paths part: one layer of Qwen3-MoE at
full width (param_dtype = compute_dtype = float16, weights from seed 0
on the card), ``apply_moe`` on the grouped-matmul kernel and on the
einsum path, each against the same layer in f32 (its fp16 weights and
tokens upcast exactly, the einsum path with TF32 off), at a decode step
(4 tokens) and a 128-token prefill of 4 slots (512 tokens); the einsum
path with cuBLAS's reduced-precision fp16 reductions allowed (PyTorch's
default, ``torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction``)
and not.  Then the model cut to MOE_LAYERS layers at fp16
(:func:`_model_logits`): the two paths' prefill and decode-step
logits against each other row by row, the tokens each layer routes to
other experts on the two paths, and each path against f32.  Needs one
GPU.

    PYTHONPATH=src python3 probes/moe_fp16_precision.py
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    """Run the comparisons the module docstring names."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.models.moe import apply_moe, init_moe

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    cfg = get_config(cs.MOE_ARCH).scaled(n_layers=1, param_dtype="float16",
                                         compute_dtype="float16")
    p = init_moe(cfg, torch.Generator(device=dev).manual_seed(0))
    p32 = {k: v.float() for k, v in p.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    matmul = torch.backends.cuda.matmul
    with torch.no_grad():
        for label, t in (("decode", cs.MOE_SLOTS),
                         ("prefill", cs.MOE_SLOTS * cs.MOE_PROMPT)):
            x = torch.randn(t, cfg.d_model, generator=gen, device=dev).to(
                torch.float16)
            ref, _ = apply_moe(cfg.scaled(moe_kernel_dispatch=False), p32,
                               x.float())
            kernel, _ = apply_moe(cfg, p, x)
            out = {"kernel": kernel}
            for allow in (True, False):
                matmul.allow_fp16_reduced_precision_reduction = allow
                out[f"einsum, reduced-precision reductions {allow}"], _ = \
                    apply_moe(cfg.scaled(moe_kernel_dispatch=False), p, x)
            matmul.allow_fp16_reduced_precision_reduction = True
            for name, y in out.items():
                print(f"MoE layer, {label} ({t} tokens) {name}: relative L2 "
                      f"{cs.rel_l2(y, ref):.3e} against f32", flush=True)
        del p, p32
        torch.cuda.empty_cache()
        _model_logits(cfg.scaled(n_layers=cs.MOE_LAYERS), dev)


def _model_logits(cfg, dev):
    """The model cut to MOE_LAYERS layers at fp16 on both MoE paths:
    prefill (4 slots of a 128-token prompt, last-token logits) and one
    decode step, each row's relative L2 between the paths, the experts
    each layer routes every token to on both paths (the tokens whose
    top-k sets differ), and each path against the same model in f32
    (its fp16 weights upcast in place, the einsum path)."""
    import torch

    import chip_smoke as cs
    import repro_torch.models.moe as moe
    from repro_torch.models import get_model

    api = get_model(cfg)
    einsum = get_model(cfg.scaled(moe_kernel_dispatch=False))
    params = api.init(torch.Generator(device=dev).manual_seed(cs.SEED),
                      device=dev)
    prompt = torch.as_tensor(cs.moe_prompts(cfg)[0][None, :],
                             dtype=torch.int64, device=dev).repeat(
        cs.MOE_SLOTS, 1)
    route = moe._route
    chosen = []

    def recording(cfg_, x, router):
        gates, probs = route(cfg_, x, router)
        chosen.append(gates > 0)
        return gates, probs

    moe._route = recording
    runs = {}
    try:
        for name, a in (("kernel", api), ("einsum", einsum)):
            chosen.clear()
            lp, cache = a.prefill(params, {"tokens": prompt}, cs.MOE_MAX_LEN)
            nxt = lp.argmax(-1) if name == "kernel" else runs["kernel"][2]
            ld, _ = a.decode_step(params, cache, nxt)
            runs[name] = (lp, ld, nxt, list(chosen))
    finally:
        moe._route = route
    k, e = runs["kernel"], runs["einsum"]
    for i, label in enumerate(("prefill", "decode step")):
        rows = [cs.rel_l2(k[i][r], e[i][r]) for r in range(k[i].shape[0])]
        print(f"{cfg.n_layers}-layer fp16 model, {label}: kernel against "
              f"einsum relative L2 {cs.rel_l2(k[i], e[i]):.3e}, by row "
              + ", ".join(f"{x:.3e}" for x in rows), flush=True)
    n_pre = cfg.n_layers
    for c, (mk, me) in enumerate(zip(k[3], e[3])):
        phase = "prefill" if c < n_pre else "decode"
        layer = c % n_pre
        differ = int((mk != me).any(dim=1).sum())
        print(f"{phase} layer {layer}: {differ} of {mk.shape[0]} tokens "
              f"routed to other experts on the two paths", flush=True)
    for layer in params["layers"]:
        for key, v in layer["moe"].items():
            layer["moe"][key] = v.float()
        for key, v in layer["attn"].items():
            layer["attn"][key] = _tree(v, lambda t: t.float())
        for key in ("ln1", "ln2"):
            layer[key] = _tree(layer[key], lambda t: t.float())
    params["embed"] = _tree(params["embed"], lambda t: t.float())
    params["final_norm"] = _tree(params["final_norm"], lambda t: t.float())
    torch.cuda.empty_cache()
    api32 = get_model(cfg.scaled(param_dtype="float32",
                                 compute_dtype="float32",
                                 moe_kernel_dispatch=False))
    lp, cache = api32.prefill(params, {"tokens": prompt}, cs.MOE_MAX_LEN)
    ld, _ = api32.decode_step(params, cache, k[2])
    for name, run in runs.items():
        print(f"{cfg.n_layers}-layer fp16 model {name} against f32: prefill "
              f"{cs.rel_l2(run[0], lp):.3e}, decode step "
              f"{cs.rel_l2(run[1], ld):.3e}", flush=True)


def _tree(tree, fn):
    """``fn`` on every tensor of a parameter tree."""
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    main()
