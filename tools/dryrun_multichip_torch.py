#!/usr/bin/env python
"""One data-parallel training step of the flagship detector over n ranks,
and its tensor- and sequence-parallel arms (the PyTorch port's
counterpart of ``__graft_entry__.py::dryrun_multichip``).

    python tools/dryrun_multichip_torch.py [N] [--device cuda|cuda:0|cpu]
        [--backend gloo|nccl]

``dryrun_multichip(n)`` starts n ranks on the card by default (gloo by
default; ``device="cuda"`` puts rank r on card r where there are n cards
and every rank on card 0, sharing it over gloo, where there are fewer;
``"cuda:0"`` puts every rank on card 0, which only gloo allows;
``device="cpu"`` (``--device cpu``) asks for the CPU; without a card any
CUDA device raises) and runs, at the flagship shape
(ResNet-50 (3,4,6,3), 96 proposals, pre-NMS top-k 100, 64 detections)
on 64^2 frames:

* DP: one step of ``parallel.dp.make_train_step`` (SGD with momentum on
  the log schedule) on a global batch of n frames, one a rank, against
  the same loss and gradient on the whole batch in one rank: loss within
  1e-5, grad norm within 1e-5 relative;
* sharded inference: ``make_sharded_inference`` over one two-frame clip
  a rank;
* TP (n even): the trained weights split by ``parallel.tp.place_tp``
  over a ``(n/2, 2)`` mesh, a clip's boxes against the unsplit
  pipeline's, within 1e-4;
* SP: ``parallel.cp.sharded_track_iou`` with the frames split over the
  ranks against the whole video's, within 1e-6.

Prints the JAX dryrun's line (plus the backend and the device) and
returns its numbers.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

# The JAX dryrun's bounds.
LOSS_TOL = 1e-5
GRAD_NORM_RTOL = 1e-5
TP_BOX_TOL = 1e-4
SP_TOL = 1e-6
H = W = 64
GT = 4
FLAGSHIP = dict(num_classes=8, num_dets=64, num_proposals=96,
                pre_nms_topk=100, backbone_stages=(3, 4, 6, 3))


def _batch(n, rng):
    boxes = np.array([[4, 4, 30, 30], [10, 10, 50, 40], [2, 8, 20, 60],
                      [30, 30, 60, 60]], np.float32)
    amodal = np.array([[2, 2, 34, 34], [8, 8, 54, 44], [0, 4, 24, 64],
                       [26, 26, 64, 64]], np.float32)
    return {
        "images": rng.rand(n, H, W, 3).astype(np.float32),
        "gt_boxes": np.tile(boxes, (n, 1, 1)),
        "gt_amodal": np.tile(amodal, (n, 1, 1)),
        "gt_classes": np.ones((n, GT), np.int32),
        "gt_valid": np.ones((n, GT), bool),
    }


def _pipeline(device):
    import torch

    from tao_amodal_torch.pipeline import AmodalPipeline

    return AmodalPipeline.create(**FLAGSHIP, device=device).init(
        torch.Generator().manual_seed(0))


def _rank(rank, n, device):
    import torch
    import torch.distributed as dist

    from tao_amodal_torch.ops.track_iou import track_iou_partials
    from tao_amodal_torch.parallel import cp, dp, tp
    from tao_amodal_torch.parallel.mesh import make_mesh, shard_batch
    from tao_amodal_torch.pipeline import make_sharded_inference
    from tao_amodal_torch.train import optim
    from tao_amodal_torch.train.step import (
        TrainStep,
        detector_draws,
        detector_loss,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data=n, device=device)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    pipe = _pipeline(dev)
    rng = np.random.RandomState(0)
    batch = _batch(n, rng)

    def optimizer():
        return optim.make_optimizer(optim.log_schedule(1e-3, 1e-5, 100))

    # The oracle first (the step trains the pipeline in place): the same
    # loss on the whole batch in one rank, on the global draws.
    if rank == 0:
        one = TrainStep(pipe, optimizer(), detector_loss, detector_draws)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        loss_sd, _, grads_sd = one.loss_and_grads(
            batch, detector_draws(batch, gen))
        loss_sd = float(loss_sd)
        gnorm_sd = float(optim.global_norm(grads_sd))
        del grads_sd
    step = dp.make_train_step(detector_loss, optimizer(), mesh, model=pipe,
                              draws_fn=detector_draws)
    state = step.init_state()
    state, metrics = step(state, shard_batch(mesh, batch), 1)
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    if not np.isfinite(loss):
        raise AssertionError(f"rank {rank}: loss {loss}")

    infer = make_sharded_inference(pipe, mesh)
    out = infer(torch.zeros((1, 2, H, W, 3), device=dev))
    shapes = [None] * n
    dist.all_gather_object(shapes, tuple(out["boxes"].shape))
    infer_shape = (sum(s[0] for s in shapes),) + shapes[0][1:]

    tp_delta = float("nan")
    test_clip = torch.from_numpy(rng.rand(2, H, W, 3).astype(np.float32))
    if n % 2 == 0:
        mesh_tp = make_mesh(data=n // 2, model=2, device=device)
        split = _pipeline(dev)
        split.load_state_dict(pipe.state_dict())
        tp.place_tp(split, mesh_tp)
        out_tp = split(test_clip.to(dev))
        out_1d = pipe(test_clip.to(dev))
        tp_delta = float((out_tp["boxes"].float()
                          - out_1d["boxes"].float()).abs().max())
        if not tp_delta <= TP_BOX_TOL:
            raise AssertionError(f"rank {rank}: TP boxes {tp_delta}")

    D, Gt, F = 4, 3, 2 * n
    db = rng.rand(D, F, 4).astype(np.float32) * 32
    db[..., 2:] += db[..., :2] + 4
    gb = rng.rand(Gt, F, 4).astype(np.float32) * 32
    gb[..., 2:] += gb[..., :2] + 4
    dv = rng.rand(D, F) > 0.2
    gv = rng.rand(Gt, F) > 0.2
    iou_sp = cp.sharded_track_iou(mesh, db, dv, gb, gv).cpu()
    i_sd, u_sd = track_iou_partials(*map(torch.from_numpy, (db, dv, gb, gv)))
    iou_sd = torch.where(u_sd > 0, i_sd / torch.where(u_sd > 0, u_sd, 1.0),
                         0.0)
    sp_delta = float((iou_sp - iou_sd).abs().max())
    if not sp_delta <= SP_TOL:
        raise AssertionError(f"rank {rank}: SP track IoU {sp_delta}")
    if rank != 0:
        return None

    loss_delta = abs(loss - loss_sd)
    gnorm_delta = abs(gnorm - gnorm_sd) / max(gnorm_sd, 1.0)
    if not (loss_delta <= LOSS_TOL and gnorm_delta <= GRAD_NORM_RTOL):
        raise AssertionError(
            f"DP step against one rank: loss {loss} / {loss_sd}, grad norm "
            f"{gnorm} / {gnorm_sd}")
    return dict(loss=loss, grad_norm=gnorm, ranks=n, device=str(dev),
                sharded_infer_boxes=infer_shape, loss_delta=loss_delta,
                grad_norm_rel_delta=gnorm_delta, tp_delta=tp_delta,
                sp_delta=sp_delta)


def dryrun_multichip(n_devices, device="cuda", backend="gloo",
                     timeout=600.0, threads=None):
    """Run the dryrun over ``n_devices`` ranks; print its line and return
    rank 0's numbers, with its ``device`` (a failed bound raises)."""
    from tao_amodal_torch.parallel.launch import rank_device, run_ranks

    device = rank_device(device, n_devices)
    r = run_ranks(_rank, n_devices, args=(n_devices, device),
                  backend=backend, timeout=timeout, threads=threads)[0]
    print(f"dryrun_multichip({n_devices}): loss={r['loss']:.4f} "
          f"grad_norm={r['grad_norm']:.4f} devices={r['ranks']} "
          f"sharded_infer_boxes={r['sharded_infer_boxes']} "
          f"sharded_vs_single_loss_delta={r['loss_delta']:.2e} "
          f"grad_norm_rel_delta={r['grad_norm_rel_delta']:.2e} "
          f"tp_forward_boxes_delta={r['tp_delta']:.2e} "
          f"sp_track_iou_delta={r['sp_delta']:.2e} "
          f"backend={backend} device={device}", flush=True)
    return r


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    args = p.parse_args(argv)
    return dryrun_multichip(args.n, device=args.device, backend=args.backend)


if __name__ == "__main__":
    main()
