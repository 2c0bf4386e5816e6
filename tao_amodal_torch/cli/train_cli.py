"""Siamese tracker training CLI.

Port of :mod:`tao_amodal_tpu.cli.train_cli` (the capability of the
reference's ``pysot/tools/train.py``): the model, loss and optimizer from
the config tree (:mod:`tao_amodal_torch.config`), one train step over
every leaf (BatchNorm statistics too, as JAX trains them), and the
:class:`~tao_amodal_torch.train.loop.Trainer`'s checkpoints and resume.
Flags match the JAX CLI's; ``--cpu`` runs on the CPU, and otherwise the
run is on the card.  ``--smoke`` trains 2 epochs of 4 steps on synthetic
pairs at 64/128 crops; ``--dataset``/``--dataset_root`` read pairs from
an on-disk benchmark layout (:mod:`tao_amodal_torch.data.sot_train`).
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
from torch.profiler import record_function

logger = logging.getLogger(__name__)

# Profiler ranges of the Siamese step: the model's forward and the anchor
# targets (the optimizer's is train/step.py's OPTIMIZER_RANGE).
MODEL_RANGE = "train:siamese_forward"
TARGETS_RANGE = "train:anchor_targets"
STEPS_PER_EPOCH = 50


def synthetic_pair_batch(rng, batch_size, cfg):
    """Synthetic (template, search, box) numpy batches: a bright square on
    noise, the box jittered off-centre (the JAX CLI's, byte for byte from
    the same ``RandomState``)."""
    z = cfg.track.exemplar_size
    x = cfg.track.instance_size
    tmpl = rng.rand(batch_size, z, z, 3).astype(np.float32) * 50
    srch = rng.rand(batch_size, x, x, 3).astype(np.float32) * 50
    boxes = np.zeros((batch_size, 4), np.float32)  # cx, cy, w, h
    for i in range(batch_size):
        w, h = rng.uniform(30, 80, 2)
        cx = x / 2 + rng.uniform(-30, 30)
        cy = x / 2 + rng.uniform(-30, 30)
        sq = np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                      int)
        srch[i, max(sq[1], 0):sq[3], max(sq[0], 0):sq[2]] += 150
        tw, th = int(w * z / x), int(h * z / x)
        t0 = (z - tw) // 2, (z - th) // 2
        tmpl[i, t0[1]:t0[1] + th, t0[0]:t0[0] + tw] += 150
        boxes[i] = [cx, cy, w, h]
    return {"template": tmpl, "search": srch, "box": boxes}


def build_siamese_training(cfg, device="cuda"):
    """``(step, state)``: the Siamese train step (a
    :class:`~tao_amodal_torch.train.step.TrainStep`) and its initial
    state, on ``device``.

    The model is JAX's ``SiameseTracker(num_levels=3)`` with seeded
    weights (seed ``cfg.train.epochs``, where JAX keys its init; load
    others into ``step.model``, in place); anchors at the model's
    response size; SGD with momentum, weight decay and global-norm
    clipping on a warmup then log schedule over 50 steps an epoch; the
    loss of :func:`~tao_amodal_torch.train.siamese_loss.siamese_loss` on
    :func:`~tao_amodal_torch.train.anchor_target.assign_anchor_targets`'s
    targets, whose draws the step takes from its generator
    (:func:`~tao_amodal_torch.train.anchor_target.anchor_draws`)."""
    import torch

    from tao_amodal_torch.trackers.factory import seeded_model
    from tao_amodal_torch.trackers.siamrpn import (
        SiamConfig,
        generate_anchors,
    )
    from tao_amodal_torch.train.anchor_target import (
        anchor_draws,
        assign_anchor_targets,
    )
    from tao_amodal_torch.train.optim import (
        make_optimizer,
        warmup_log_schedule,
    )
    from tao_amodal_torch.train.siamese_loss import siamese_loss
    from tao_amodal_torch.train.step import TrainStep
    from tao_amodal_torch.utils.weights import variable_names

    model = seeded_model(seed=cfg.train.epochs, device=device)
    t = cfg.track
    scfg = SiamConfig(exemplar_size=t.exemplar_size,
                      instance_size=t.instance_size, base_size=t.base_size,
                      stride=t.stride, ratios=tuple(t.ratios),
                      scales=tuple(t.scales))
    ss = model.response_size(scfg.exemplar_size, scfg.instance_size)
    anchors = torch.from_numpy(generate_anchors(scfg, ss=ss)).to(
        model.device)

    tr = cfg.train
    sched = warmup_log_schedule(
        tr.start_lr / 10, tr.start_lr, tr.warmup_epochs * STEPS_PER_EPOCH,
        tr.start_lr, tr.end_lr, tr.epochs * STEPS_PER_EPOCH)
    optimizer = make_optimizer(sched, weight_decay=tr.weight_decay,
                               momentum=tr.momentum, clip_norm=tr.grad_clip)

    def loss_fn(model, batch, draws):
        with record_function(MODEL_RANGE):
            outputs = model(template=batch["template"],
                            search=batch["search"], mode="train")
        with record_function(TARGETS_RANGE):
            targets = assign_anchor_targets(anchors, batch["box"], draws)
        return siamese_loss(outputs, targets, cls_weight=tr.cls_weight,
                            loc_weight=tr.loc_weight)

    def draws_fn(batch, generator):
        return anchor_draws(len(batch["box"]), len(anchors), generator)

    step = TrainStep(model, optimizer, loss_fn, draws_fn, variable_names)
    return step, step.init_state()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, default=None,
                        help="experiment YAML merged over defaults")
    parser.add_argument("--opts", nargs="*", default=[],
                        help="dotted-path overrides: key value ...")
    parser.add_argument("--smoke", action="store_true",
                        help="synthetic data, 2 tiny epochs")
    parser.add_argument("--dataset", default=None,
                        help="train from an on-disk benchmark layout: "
                             "otb | vot | lasot | got10k | trackingnet "
                             "(train splits; reference "
                             "ltr/dataset/ + pysot TrkDataset "
                             "capability)")
    parser.add_argument("--dataset_root", default=None)
    parser.add_argument("--neg_prob", type=float, default=0.2)
    parser.add_argument("--frame_range", type=int, default=100)
    parser.add_argument("--checkpoint_dir", default="./checkpoints")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (smoke/testing); the default "
                             "is the card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from tao_amodal_torch.config import default_config
    from tao_amodal_torch.data.loader import to_device
    from tao_amodal_torch.train.loop import TrainConfig, Trainer

    device = "cpu" if args.cpu else "cuda"
    cfg = default_config()
    if args.config:
        cfg.merge_from_file(args.config)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.smoke:
        cfg.track.exemplar_size = 64
        cfg.track.instance_size = 128
        cfg.track.base_size = 0
        cfg.train.epochs = 2
        cfg.train.batch_size = 8

    step, state = build_siamese_training(cfg, device=device)

    rng = np.random.RandomState(0)
    steps = 4 if args.smoke else STEPS_PER_EPOCH

    if args.dataset and args.dataset_root:
        from tao_amodal_torch.data.sot_datasets import load_sot_dataset
        from tao_amodal_torch.data.sot_train import (
            SotSequenceSource,
            pair_batch_iter,
        )
        from tao_amodal_torch.train.sampler import TrackPairSampler

        source = SotSequenceSource(
            load_sot_dataset(args.dataset, args.dataset_root))
        if source.num_tracks == 0:
            raise SystemExit(
                f"no usable sequences under {args.dataset_root}")
        sampler = TrackPairSampler(
            [source], frame_range=args.frame_range,
            neg_prob=args.neg_prob, seed=0)
        pairs = pair_batch_iter(
            sampler, [source], cfg.train.batch_size,
            exemplar_size=cfg.track.exemplar_size,
            instance_size=cfg.track.instance_size)

        def data_iter(epoch):
            for _ in range(steps):
                yield to_device(next(pairs), device)
    else:
        def data_iter(epoch):
            for _ in range(steps):
                yield to_device(synthetic_pair_batch(
                    rng, cfg.train.batch_size, cfg), device)

    trainer = Trainer(
        step, state, data_iter,
        TrainConfig(num_epochs=cfg.train.epochs,
                    steps_per_epoch=steps,
                    checkpoint_dir=args.checkpoint_dir,
                    log_every=2 if args.smoke else 20))
    trainer.train(load_latest=args.resume)
    logger.info("training finished at epoch %d", trainer.epoch)
    return trainer


if __name__ == "__main__":
    main()
