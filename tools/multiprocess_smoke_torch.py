#!/usr/bin/env python
"""Multi-process smoke of the PyTorch port's scale-out layer: a real
two-process ``torch.distributed`` job over gloo, the counterpart of
``tools/multiprocess_smoke.py``.

    python tools/multiprocess_smoke_torch.py [--cpu]

The ranks run on the card by default (one card a rank where there are
two, else both sharing the first card, ``parallel/launch.py::
rank_device``) and raise without one; ``--cpu`` asks for the CPU.

Each process takes its shard of a global batch (``parallel.host``) and
checks: the global mean over both processes' shards equals the whole
batch's; gathering the shards gives the whole batch back; the
``ShardedSampler``'s shards are disjoint and cover the samples; and one
data-parallel detector step (``parallel.dp``) fed by the local shards
equals the one-process step on the whole batch, which this launcher runs
itself (loss within 1e-5 relative, grad norm within 1e-4, JAX's bounds).
Prints one OK line a process, ``2/2 workers OK`` and ``TRAIN PARITY
OK``; exits 1 on any failure.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

NUM_PROCESSES = 2
TINY = dict(num_classes=8, num_dets=8, num_proposals=16,
            backbone_stages=(1, 1, 1, 1))
SAMPLES = 10
LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4


def _make_batch(B):
    """Deterministic global batch (the same in every process)."""
    rng = np.random.RandomState(0)
    return {
        "images": rng.rand(B, 64, 64, 3).astype(np.float32),
        "gt_boxes": np.tile(
            np.array([[4, 4, 30, 30], [10, 10, 50, 40],
                      [2, 8, 20, 60], [30, 30, 60, 60]], np.float32),
            (B, 1, 1)),
        "gt_amodal": np.tile(
            np.array([[2, 2, 34, 34], [8, 8, 54, 44],
                      [0, 4, 24, 64], [26, 26, 64, 64]], np.float32),
            (B, 1, 1)),
        "gt_classes": np.ones((B, 4), np.int32),
        "gt_valid": np.ones((B, 4), bool),
    }


def _train_step(mesh, batch):
    """One data-parallel detector + expander step (SGD, JAX's
    ``make_optimizer``) on ``mesh`` (on its device) from a seeded init:
    (loss, grad norm)."""
    import torch

    from tao_amodal_torch.parallel.dp import make_train_step
    from tao_amodal_torch.pipeline import AmodalPipeline
    from tao_amodal_torch.train.optim import log_schedule, make_optimizer
    from tao_amodal_torch.train.step import detector_draws, detector_loss

    # f32 parity: cuDNN convolutions and matmuls default to TF32 on the card.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = AmodalPipeline.create(**TINY, device=mesh.device).init(
        torch.Generator().manual_seed(0))
    step = make_train_step(
        detector_loss, make_optimizer(log_schedule(1e-3, 1e-5, 100)), mesh,
        model=pipe, draws_fn=detector_draws)
    _, metrics = step(step.init_state(), batch, 1)
    return float(metrics["loss"]), float(metrics["grad_norm"])


def worker(rank, device):
    import torch
    import torch.distributed as dist

    from tao_amodal_torch.parallel.host import (
        ShardedSampler,
        global_batch_from_local,
        host_shard_indices,
    )
    from tao_amodal_torch.parallel.mesh import make_mesh

    assert dist.get_world_size() == NUM_PROCESSES
    mesh = make_mesh(device=device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    # Every process loads its shard of the global batch.
    G = 16
    sl = host_shard_indices(G)
    full = np.arange(G * 8, dtype=np.float32).reshape(G, 8)
    local = global_batch_from_local(mesh, {"x": full[sl]}, G)["x"]

    # The global mean over the processes' shards.
    sums = torch.stack([local.sum(), torch.tensor(float(local.numel()),
                                                  device=local.device)])
    dist.all_reduce(sums)
    got = float(sums[0] / sums[1])
    assert abs(got - float(full.mean())) < 1e-5, (got, full.mean())

    # Round trip: every process gathers the whole batch back.
    parts = [torch.empty_like(local) for _ in range(NUM_PROCESSES)]
    dist.all_gather(parts, local)
    np.testing.assert_allclose(torch.cat(parts).cpu().numpy(), full)

    # The sampler's shards: disjoint and complete.
    mine = ShardedSampler(SAMPLES, seed=3).epoch_indices(0).tolist()
    assert len(mine) == SAMPLES // NUM_PROCESSES
    shards = [None] * NUM_PROCESSES
    dist.all_gather_object(shards, mine)
    assert sorted(sum(shards, [])) == list(range(SAMPLES)), shards

    # A data-parallel detector step fed by the local shards.
    B = NUM_PROCESSES
    batch = global_batch_from_local(
        mesh, {k: v[host_shard_indices(B)] for k, v in
               _make_batch(B).items()}, B)
    loss, gnorm = _train_step(mesh, batch)
    print(f"MULTIPROCESS OK process={rank} ranks={dist.get_world_size()} "
          f"device={mesh.device} mean={got}", flush=True)
    return loss, gnorm


def launch(device="cuda"):
    """Both workers, then the one-process step, on ``device``; 0 if all
    agree."""
    from tao_amodal_torch.parallel.host import global_batch_from_local
    from tao_amodal_torch.parallel.launch import (
        RankFailure,
        rank_device,
        run_ranks,
    )
    from tao_amodal_torch.parallel.mesh import make_mesh

    device = rank_device(device, NUM_PROCESSES)
    try:
        losses = run_ranks(worker, NUM_PROCESSES, args=(device,), threads=1)
    except RankFailure as e:
        print(f"0/{NUM_PROCESSES} workers OK", flush=True)
        sys.stderr.write(f"{e}\n")
        return 1
    print(f"{NUM_PROCESSES}/{NUM_PROCESSES} workers OK", flush=True)
    mesh = make_mesh(device=device)
    ref = _train_step(mesh, global_batch_from_local(
        mesh, _make_batch(NUM_PROCESSES), NUM_PROCESSES))
    for i, (loss, gnorm) in enumerate(losses):
        dl = abs(loss - ref[0]) / max(abs(ref[0]), 1e-9)
        dg = abs(gnorm - ref[1]) / max(abs(ref[1]), 1e-9)
        print(f"worker {i}: loss rel-delta {dl:.2e}, grad_norm rel-delta "
              f"{dg:.2e} (ref loss {ref[0]:.6f})")
        if dl > LOSS_RTOL or dg > GRAD_NORM_RTOL:
            sys.stderr.write("TRAIN PARITY FAILED\n")
            return 1
    print("TRAIN PARITY OK")
    return 0


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="run the ranks on the CPU (default: the card)")
    args = p.parse_args(argv)
    return launch("cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    sys.exit(main())
