"""The training step of ``chip_smoke.py``'s ``lm_train`` phase for the port
in a given source tree, so that two commits can be timed in turns within
one run on the same card.

    PYTHONPATH=src python3 probes/time_lm_train.py [SRC]

SRC is the ``src`` directory of a checkout (by default this one's); its
``repro_torch`` is imported (its kernels built into its own ``_build``),
while the configuration (Qwen3-MoE at full width cut to 1 layer, batch 8
x 256, AdamW at 1e-3 x 64 / 4096, seed 0) and the timers come from this
checkout's ``chip_smoke.py``.  ``Trainer`` runs LM_STEPS steps with CUDA
events around each step and around each grouped-matmul launch
(``chip_smoke.LaunchTimer``); it prints the step ms (mean of steps 2-8),
the grouped matmul's forward, dx and dW ms a step, the peak of
``torch.cuda.max_memory_allocated`` and the losses.  Needs one GPU.
"""
import sys
import tempfile
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
    from repro_torch.data.synthetic import ShardedTokenStream
    from repro_torch.kernels import build
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import AdamW, constant_schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    print(f"repro_torch from {Path(repro_torch.__file__).parent}",
          flush=True)
    build.build()
    dev = torch.device("cuda")
    cfg = cs.lm_config()
    lr = cs.LM_LR * cs.LM_REFERENCE_WIDTH / cfg.d_model
    api = get_model(cfg)
    data = ShardedTokenStream(cfg.vocab_size, cs.LM_SEQ, cs.LM_BATCH,
                              seed=cs.SEED)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckpt:
        tr = cs.one_host(Trainer(
            api, AdamW(lr=constant_schedule(lr), weight_decay=0.0),
            iter(data), ckpt_dir=ckpt,
            tcfg=TrainerConfig(total_steps=cs.LM_STEPS,
                               ckpt_every=cs.LM_STEPS + 1, log_every=1),
            device=dev))
        state = tr.init_or_restore(torch.Generator(device=dev).manual_seed(
            cs.SEED))
        events, step_fn = [], tr.step_fn

        def timed(st, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step_fn(st, batch)
            end.record()
            events.append((start, end))
            return out

        tr.step_fn = timed
        with cs.LaunchTimer() as lt:
            tr.run(state)
        launch_ms = lt.ms()
    torch.cuda.synchronize()
    step_ms = [s.elapsed_time(e) for s, e in events]
    losses = tr.losses()
    gmm = {n: launch_ms.get(n, 0.0) / cs.LM_STEPS
           for n in ("grouped_matmul", "grouped_matmul_dx",
                     "grouped_matmul_dw")}
    print(f"lm_train at lr {lr:.4g}: step ms (CUDA events) "
          + ", ".join(f"{v:.4f}" for v in step_ms)
          + f"; mean of steps 2-{cs.LM_STEPS} "
          f"{sum(step_ms[1:]) / (len(step_ms) - 1):.4f} ms; grouped-matmul "
          "ms a step " + ", ".join(f"{n} {v:.4f}" for n, v in gmm.items())
          + f"; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          "losses " + ", ".join(f"{v:.6f}" for v in losses), flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
