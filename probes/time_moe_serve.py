"""The end-to-end times of ``chip_smoke.py``'s ``moe_serve`` phase for the
port in a given source tree, so that two commits can be timed in turns
within one run on the same card.

    PYTHONPATH=src python3 probes/time_moe_serve.py [SRC]

SRC is the ``src`` directory of a checkout (by default this one's); its
``repro_torch`` is imported, while the configuration (Qwen3-MoE at full
width cut to 4 layers, random weights from seed 0 drawn on the card,
``ServeEngine`` with 4 slots serving 8 requests of 128-token prompts, 16
greedy tokens each) and the timers come from this checkout's
``chip_smoke.py``.  It serves the requests once to warm up, then three
times on the host clock (tokens/s), and times one prefill and one
decode step as ``chip_smoke.py`` does (CUDA events, means of 10 after
warm-up), five times each, printing every mean and their median; then
``chip_smoke.profile_step`` gives each step's kernel time and busy share
under ``torch.profiler``.  Needs one GPU.
"""
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    sys.path[:0] = [str(src), str(ROOT)]
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    import repro_torch
    from repro_torch.serve import Request, ServeEngine

    print(cs.card_line(), flush=True)
    print(f"repro_torch from {Path(repro_torch.__file__).parent}",
          flush=True)
    dev = torch.device("cuda")
    cfg, api, _, params = cs.moe_model(dev)
    prompts = cs.moe_prompts(cfg)

    def serve():
        engine = ServeEngine(api, params, slots=cs.MOE_SLOTS,
                             max_len=cs.MOE_MAX_LEN, device=dev)
        for rid, p in enumerate(prompts):
            engine.submit(Request(rid=rid, prompt=p,
                                  max_new_tokens=cs.MOE_NEW))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run_to_completion()
        torch.cuda.synchronize()
        return sum(len(v) for v in results.values()), \
            time.perf_counter() - t0

    serve()
    rates = []
    for _ in range(3):
        n_tok, seconds = serve()
        rates.append(n_tok / seconds)
    print(f"engine: {n_tok} tokens a run, tokens/s (host clock) "
          + ", ".join(f"{r:.1f}" for r in rates)
          + f"; median {statistics.median(rates):.1f}", flush=True)

    tokens = torch.as_tensor(prompts[0][None, :], dtype=torch.int64,
                             device=dev)
    cache = api.init_cache(cs.MOE_SLOTS, cs.MOE_MAX_LEN, device=dev)
    cache["pos"] = cs.MOE_PROMPT
    step_tokens = torch.zeros(cs.MOE_SLOTS, dtype=torch.int64, device=dev)
    steps = {"prefill": lambda: api.prefill(params, {"tokens": tokens},
                                            cs.MOE_MAX_LEN),
             "decode step": lambda: api.decode_step(params, cache,
                                                    step_tokens)}
    for label, fn in steps.items():
        means = [cs.cuda_ms(fn, 10, 2) for _ in range(5)]
        print(f"{label}: ms (CUDA events, means of 10) "
              + ", ".join(f"{m:.4f}" for m in means)
              + f"; median {statistics.median(means):.4f}", flush=True)
        cs.profile_step(label, fn)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
