"""Detector + Amodal-Expander training CLI.

Port of :mod:`tao_amodal_tpu.cli.train_detector_cli`: the composite RPN
+ RoI + expander loss (:mod:`tao_amodal_torch.train.detector_loss`),
AdamW on a log schedule over every leaf (BatchNorm statistics too, as
JAX trains them), the :class:`~tao_amodal_torch.train.loop.Trainer`'s
checkpoints and resume, on synthetic frames and boxes.  Flags match the
JAX CLI's; ``--cpu`` runs on the CPU, and otherwise the run is on the
card.  Without ``--smoke`` the model is ``AmodalPipeline.create()``'s
(ResNet-50 + FPN-256, 80 classes) on batches of 512^2 frames, 50 steps
an epoch; ``--smoke`` runs 2 epochs of 3 steps of a (1,1,1,1) trunk on
64^2 frames.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)


def synthetic_detection_batch(rng, batch_size, hw=128, max_gt=4):
    """A numpy batch of bright rectangles on noise (the JAX CLI's, byte
    for byte from the same ``RandomState``)."""
    H = W = hw
    images = rng.rand(batch_size, H, W, 3).astype(np.float32) * 40
    gt_boxes = np.zeros((batch_size, max_gt, 4), np.float32)
    gt_amodal = np.zeros((batch_size, max_gt, 4), np.float32)
    gt_classes = np.zeros((batch_size, max_gt), np.int32)
    gt_valid = np.zeros((batch_size, max_gt), bool)
    for b in range(batch_size):
        n = rng.randint(1, max_gt + 1)
        for g in range(n):
            w, h = rng.uniform(20, 60, 2)
            x0 = rng.uniform(0, W - w)
            y0 = rng.uniform(0, H - h)
            images[b, int(y0):int(y0 + h), int(x0):int(x0 + w)] += 160
            gt_boxes[b, g] = [x0, y0, x0 + w, y0 + h]
            # Amodal box extends beyond the visible one.
            gt_amodal[b, g] = [x0 - 0.1 * w, y0 - 0.1 * h,
                               x0 + 1.1 * w, y0 + 1.1 * h]
            gt_classes[b, g] = rng.randint(1, 4)
            gt_valid[b, g] = True
    return {"images": images, "gt_boxes": gt_boxes,
            "gt_amodal": gt_amodal, "gt_classes": gt_classes,
            "gt_valid": gt_valid}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--checkpoint_dir", default="./det_checkpoints")
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument(
        "--paste_n_occlude", action="store_true",
        help="augment every batch with PasteNOcclude (occluders "
             "pasted over a random gt; visible boxes shrink, amodal "
             "targets stay — the expander training recipe of the "
             "reference's companion repo, README.md:99)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (smoke/testing); the default "
                             "is the card")
    parser.add_argument(
        "--occluder_bank", default=None,
        help="npz/npy of [N, P, P, 4] RGBA occluder patches (e.g. "
             "from train.paste_n_occlude.make_occluder_bank over real "
             "segments); default: the synthetic ellipse bank")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from tao_amodal_torch.data.loader import to_device
    from tao_amodal_torch.pipeline import AmodalPipeline
    from tao_amodal_torch.train.loop import TrainConfig, Trainer
    from tao_amodal_torch.train.optim import log_schedule, make_adamw
    from tao_amodal_torch.train.step import make_train_step

    device = "cpu" if args.cpu else "cuda"
    if args.smoke:
        args.epochs = 2
        pipeline = AmodalPipeline.create(
            num_classes=8, num_dets=8, num_proposals=16,
            backbone_stages=(1, 1, 1, 1), device=device)
        hw = 64
    else:
        pipeline = AmodalPipeline.create(device=device)
        hw = 512
    pipeline.init(torch.Generator(device=device).manual_seed(0))
    optimizer = make_adamw(log_schedule(1e-3, 1e-5, args.epochs * 50))
    step = make_train_step(pipeline, optimizer)

    rng = np.random.RandomState(0)
    steps = 3 if args.smoke else 50

    pno = None
    if args.paste_n_occlude:
        from tao_amodal_torch.train.paste_n_occlude import (
            paste_n_occlude_batch,
            pno_draws,
            synthetic_occluder_bank,
        )

        if args.occluder_bank:
            bank = torch.as_tensor(np.load(args.occluder_bank),
                                   dtype=torch.float32).to(device)
        else:
            bank = synthetic_occluder_bank(device=device)

        def pno(batch, step_idx):
            gen = torch.Generator(device=device)
            gen.manual_seed(9_000_000 + step_idx)
            B, G = batch["gt_valid"].shape
            img, gb, gv, _ = paste_n_occlude_batch(
                batch["images"], batch["gt_boxes"], batch["gt_amodal"],
                batch["gt_valid"], bank, pno_draws(B, G, len(bank), gen))
            return dict(batch, images=img, gt_boxes=gb, gt_valid=gv)

    def data_iter(epoch):
        for i in range(steps):
            batch = to_device(synthetic_detection_batch(
                rng, args.batch_size, hw=hw), device)
            if pno is not None:
                batch = pno(batch, epoch * steps + i)
            yield batch

    trainer = Trainer(step, step.init_state(), data_iter,
                      TrainConfig(num_epochs=args.epochs,
                                  steps_per_epoch=steps,
                                  checkpoint_dir=args.checkpoint_dir,
                                  log_every=1 if args.smoke else 20))
    trainer.train(load_latest=args.resume)
    return trainer


if __name__ == "__main__":
    main()
