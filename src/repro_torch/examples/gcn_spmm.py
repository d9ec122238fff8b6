"""2-layer GCN on a synthetic graph with the Sgap SpMM at its core (port
of ``examples/gcn_spmm.py``): the paper's own motivating workload family,
GNN aggregation.

Each layer is one scheduled SpMM: the first runs the fused path, ``act(Ã
(X W1) + b1)`` with the bias add and relu as the kernel's epilogue
(``models.layers.gcn_layer``), the second the plain aggregation of the
logits.  The backward is the port's (dz = act'(z) dOut, dvals = SDDMM(dz,
X), dX = Ãᵀ dz, ``sparse/ops.py``), so the training loop differentiates
through the same kernels it serves with.  The schedule is
``Schedule.auto`` for the graph; the kernel is checked against the
reference oracle (``impl="ref"``) before 40 SGD steps at rate 0.5.

    PYTHONPATH=src python -m repro_torch.examples.gcn_spmm [--device cpu]

It runs on the card unless ``--device cpu`` is given (the kernels' plain
versions) and prints ``gcn_spmm complete`` at the end.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import gcn_layer
from repro_torch.sparse import CSR, Schedule, matrix_stats, random_csr, spmm

N_NODES, N_FEAT, N_CLASS = 256, 32, 4
STEPS, LR = 40, 0.5


def example_inputs(device):
    """The reference's graph, features, teacher labels and initial
    weights, from the same seeds: the normalized adjacency (random
    pattern, symmetrised, self loops, D^-1/2 (S + I) D^-1/2) as a CSR on
    ``device``, the features, the labels and ``{"w1", "b1", "w2"}``."""
    adj = random_csr(N_NODES, N_NODES, density=0.02, seed=0, device="cpu")
    dense = adj.todense().numpy()
    dense = ((dense + dense.T) > 0).astype(np.float32)
    np.fill_diagonal(dense, 1.0)
    deg = dense.sum(1)
    norm = dense / np.sqrt(np.outer(deg, deg))
    a = CSR.fromdense(norm, device=device)
    rng = np.random.default_rng(0)
    feats = torch.tensor(rng.standard_normal((N_NODES, N_FEAT)),
                         dtype=torch.float32, device=device)
    w_teacher = torch.tensor(rng.standard_normal((N_FEAT, N_CLASS)),
                             dtype=torch.float32, device=device)
    labels = (torch.tensor(norm, dtype=torch.float32, device=device)
              @ feats @ w_teacher).argmax(-1)
    params = {
        "w1": torch.tensor(rng.standard_normal((N_FEAT, 64)) * 0.1,
                           dtype=torch.float32, device=device),
        "b1": torch.zeros(64, dtype=torch.float32, device=device),
        "w2": torch.tensor(rng.standard_normal((64, N_CLASS)) * 0.1,
                           dtype=torch.float32, device=device),
    }
    return a, feats, labels, params


def main(argv=None) -> list:
    """Run the example; returns the losses of the SGD steps."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: the kernels) or 'cpu' (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    a, feats, labels, params = example_inputs(dev)
    sched = Schedule.auto(matrix_stats(a), N_FEAT)
    print(f"selected aggregation schedule: {sched}")

    def gcn_fwd(p, x):
        h = gcn_layer(a, x, p["w1"], p["b1"], activation="relu",
                      schedule=sched, device=dev)
        return spmm(a, h @ p["w2"], schedule=sched, device=dev)

    h0 = feats @ params["w1"]
    np.testing.assert_allclose(
        spmm(a, h0, schedule=sched, device=dev).cpu().numpy(),
        spmm(a, h0, impl="ref", device=dev).cpu().numpy(),
        rtol=1e-4, atol=1e-4)
    print("kernel aggregation matches oracle")

    for p in params.values():
        p.requires_grad_(True)
    losses = []
    for _ in range(STEPS):
        loss = F.cross_entropy(gcn_fwd(params, feats), labels)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p.sub_(LR * g)
        losses.append(float(loss.detach()))
    print(f"GCN loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if not losses[-1] < losses[0] - 0.1:
        raise SystemExit("gcn_spmm: the loss did not fall by 0.1")
    print("gcn_spmm complete")
    return losses


if __name__ == "__main__":
    main()
