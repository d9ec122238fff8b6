"""chip_smoke.py's ``dist moe`` phase alone: builds the kernels, draws the
moe_serve model (Qwen3-MoE at full width, 4 layers), saves the one-rank
answers (``dist_moe_reference``), frees the model and runs
``dist_moe_phase``: expert-parallel serving on (1, 2), (1, 4), (2, 2),
the collective tuner and the data-parallel trainer on (2, 2) and
(2, 1), gloo ranks sharing the card.  Needs one GPU.

    python3 probes/dist_moe_phase.py
"""
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import grouped_matmul_dw as gmd  # noqa: E402

print(cs.card_line(), flush=True)
t0 = time.perf_counter()
build.build()
print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
dev = torch.device("cuda")
tmp = tempfile.mkdtemp(prefix="dist_moe_phase_")
print("disk", shutil.disk_usage(tmp), flush=True)
with torch.no_grad():
    cfg, api, einsum, params = cs.moe_model(dev)
    cs.dist_moe_reference(cfg, params, dev, tmp)
del params
torch.cuda.empty_cache()
counters = {"grouped_matmul": gm.KERNEL, "grouped_matmul_dx": gm.TRANS,
            "grouped_matmul_dw": gmd.KERNEL}
t0 = time.perf_counter()
out = cs.dist_moe_phase(tmp, counters, dev)
print("dist_moe_phase done", out, f"{time.perf_counter() - t0:.1f} s",
      flush=True)
