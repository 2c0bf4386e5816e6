"""GTR-style and pysot torch checkpoints -> the port's detector and
Siamese tracker.

The port's numpy copy of ``tao_amodal_tpu/utils/torch_convert.py`` (and
of ``load_pretrain``, ``tao_amodal_tpu/utils/checkpoint.py:32-69``): a
detectron2 / GTR R50-FPN state_dict (torchvision trunk names under
``backbone.bottom_up.``, ``backbone.fpn_lateral{3,4,5}`` /
``fpn_output{3,4,5}`` /
``top_block.p{6,7}``, ``proposal_generator.rpn_head.``,
``roi_heads.box_head.fc{1,2}`` and ``roi_heads.box_predictor``) becomes
the JAX ``ClipDetector``'s variable tree, array for array the JAX
converter's:

  * conv kernels: torch OIHW -> HWIO; Linear ``[out, in]`` -> ``[in,
    out]``;
  * BatchNorm ``weight``/``bias`` -> params ``scale``/``bias``,
    ``running_mean``/``running_var`` -> batch_stats ``mean``/``var``;
  * the box head's ``fc1`` over the pooled features: torch flattens
    ``[C, h, w]`` (channel-major), the port and JAX ``[h, w, C]``, so its
    input columns are permuted first;
  * ``cls_score``: detectron2 puts the background class last, the
    detector drops index 0 as background, so the rows are rolled.

:func:`load_gtr_checkpoint` flattens the converted tree and loads it
through :func:`tao_amodal_torch.utils.weights.load_into`.  A pysot
tracker checkpoint (the trunk under ``backbone.``, the necks as
``neck.downsample{2,3,4}.downsample.{0,1}``) converts with
:func:`convert_siamese_checkpoint` and loads into a ``SiameseTracker``
with :func:`load_siamese_checkpoint`; its heads keep their weights, as
JAX's keep their init (pysot's heads are built otherwise).
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from tao_amodal_torch.utils import weights
from tao_amodal_torch.utils.checkpoint import (  # noqa: F401
    flatten,
    load_pretrain,
    unflatten,
)

logger = logging.getLogger(__name__)


def load_torch_state_dict(path_or_dict):
    """A path to a torch checkpoint (read with ``torch.load(...,
    weights_only=True)``) or an in-memory mapping -> ``{name:
    np.ndarray}``, with the ``{'state_dict': ...}`` / ``{'model': ...}``
    containers unwrapped and the DataParallel ``module.`` prefix
    stripped."""
    if isinstance(path_or_dict, (str, bytes)) or hasattr(
            path_or_dict, "__fspath__"):
        data = torch.load(path_or_dict, map_location="cpu",
                          weights_only=True)
    else:
        data = path_or_dict
    for key in ("state_dict", "model"):
        if isinstance(data, dict) and key in data and isinstance(
                data[key], dict):
            data = data[key]
    out = {}
    for k, v in data.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def _conv(w):
    """OIHW -> HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def _put(params, stats, scope, torch_sd, conv_key, bn_key):
    """Fill one ConvBN scope from torch conv+bn entries."""
    params[scope] = {
        "Conv_0": {"kernel": _conv(torch_sd[conv_key])},
        "BatchNorm_0": {"scale": torch_sd[bn_key + ".weight"],
                        "bias": torch_sd[bn_key + ".bias"]}}
    stats[scope] = {"BatchNorm_0": {
        "mean": torch_sd[bn_key + ".running_mean"],
        "var": torch_sd[bn_key + ".running_var"]}}


def convert_resnet(torch_sd, stage_sizes=(3, 4, 6, 3), prefix=""):
    """torchvision-named ResNet state_dict -> the ``ResNet`` (classic
    stem) variables ``{'params': ..., 'batch_stats': ...}``.

    Args:
      torch_sd: flat ``{name: array}`` (:func:`load_torch_state_dict`).
      prefix: e.g. ``"backbone.bottom_up."``.
    """
    sd = {k[len(prefix):]: v for k, v in torch_sd.items()
          if k.startswith(prefix)}
    params, stats = {}, {}
    _put(params, stats, "ConvBN_0", sd, "conv1.weight", "bn1")
    blk = 0
    for stage, blocks in enumerate(stage_sizes, start=1):
        for b in range(blocks):
            t = f"layer{stage}.{b}"
            bp, bs = {}, {}
            for j in range(3):
                _put(bp, bs, f"ConvBN_{j}", sd, f"{t}.conv{j + 1}.weight",
                     f"{t}.bn{j + 1}")
            if f"{t}.downsample.0.weight" in sd:
                _put(bp, bs, "ConvBN_3", sd, f"{t}.downsample.0.weight",
                     f"{t}.downsample.1")
            params[f"Bottleneck_{blk}"] = bp
            stats[f"Bottleneck_{blk}"] = bs
            blk += 1
    unused = sorted(k for k in sd
                    if not k.startswith(("conv1.", "bn1.", "layer")))
    if unused:
        logger.info("convert_resnet: %d entries not mapped (e.g. %s)",
                    len(unused), unused[:3])
    return {"params": params, "batch_stats": stats}


def convert_adjust_necks(torch_sd, num_levels=3, prefix="neck."):
    """pysot ``AdjustAllLayer`` (``neck.downsample{2,3,4}.downsample``, or
    ``neck.downsample.downsample`` for one level) -> the ``necks_i``
    ``AdjustLayer`` variables."""
    params, stats = {}, {}
    for i in range(num_levels):
        base = next((f"{prefix}{c}" for c in (
            f"downsample{i + 2}.downsample", "downsample")
            if f"{prefix}{c}.0.weight" in torch_sd), None)
        if base is None:
            continue
        params[f"necks_{i}"] = {
            "Conv_0": {"kernel": _conv(torch_sd[f"{base}.0.weight"])},
            "BatchNorm_0": {"scale": torch_sd[f"{base}.1.weight"],
                            "bias": torch_sd[f"{base}.1.bias"]}}
        stats[f"necks_{i}"] = {"BatchNorm_0": {
            "mean": torch_sd[f"{base}.1.running_mean"],
            "var": torch_sd[f"{base}.1.running_var"]}}
    return {"params": params, "batch_stats": stats}


def _linear(w):
    """torch Linear ``[out, in]`` -> Dense kernel ``[in, out]``."""
    return np.transpose(w, (1, 0))


def _linear_on_pooled(w, pool_hw, channels):
    """A Linear over flattened pooled RoI features: torch flattens ``[C,
    h, w]``, the detector ``[h, w, C]``; permute the input columns, then
    transpose."""
    out_dim = w.shape[0]
    w = w.reshape(out_dim, channels, pool_hw, pool_hw)
    return _linear(np.transpose(w, (0, 2, 3, 1)).reshape(out_dim, -1))


def convert_fpn(torch_sd, num_laterals=3, num_extra=2, prefix="backbone.",
                first_level=3):
    """detectron2 FPN names -> the ``FPN``'s ``lateral_i``, ``post_i``
    and ``extra_j`` (``fpn_lateral{l}``, ``fpn_output{l}``,
    ``top_block.p{6,7}``; the extra levels chain without detectron2's
    interior ReLU, as the JAX FPN does)."""
    sd = {k[len(prefix):]: v for k, v in torch_sd.items()
          if k.startswith(prefix)}
    params = {}
    for i in range(num_laterals):
        lvl = first_level + i
        for ours, theirs in (("lateral", "fpn_lateral"),
                             ("post", "fpn_output")):
            params[f"{ours}_{i}"] = {
                "kernel": _conv(sd[f"{theirs}{lvl}.weight"]),
                "bias": sd[f"{theirs}{lvl}.bias"]}
    for j in range(num_extra):
        lvl = first_level + num_laterals + j
        params[f"extra_{j}"] = {
            "kernel": _conv(sd[f"top_block.p{lvl}.weight"]),
            "bias": sd[f"top_block.p{lvl}.bias"]}
    return {"params": params}


def convert_rpn_head(torch_sd, prefix="proposal_generator.rpn_head."):
    """detectron2 ``rpn_head.{conv,objectness_logits,anchor_deltas}`` ->
    the ``RPNHead``'s ``tower``/``obj``/``delta``."""
    sd = {k[len(prefix):]: v for k, v in torch_sd.items()
          if k.startswith(prefix)}
    conv = "conv" if "conv.weight" in sd else "conv.conv0"
    return {"params": {
        name: {"kernel": _conv(sd[f"{key}.weight"]),
               "bias": sd[f"{key}.bias"]}
        for name, key in (("tower", conv), ("obj", "objectness_logits"),
                          ("delta", "anchor_deltas"))}}


def convert_box_head(torch_sd, num_classes, pool_hw=7, channels=256,
                     prefix="roi_heads."):
    """detectron2 ``box_head.fc{1,2}`` + ``box_predictor.{cls_score,
    bbox_pred}`` -> the ``RoIBoxHead``'s ``Dense_0..3``, the background
    row rolled from last to first."""
    sd = {k[len(prefix):]: v for k, v in torch_sd.items()
          if k.startswith(prefix)}
    cls_w = sd["box_predictor.cls_score.weight"]
    cls_b = sd["box_predictor.cls_score.bias"]
    roll_w = np.concatenate([cls_w[-1:], cls_w[:-1]], axis=0)
    roll_b = np.concatenate([cls_b[-1:], cls_b[:-1]], axis=0)
    if roll_w.shape[0] != num_classes + 1:
        raise ValueError(f"cls_score has {roll_w.shape[0]} rows, want "
                         f"{num_classes + 1}")
    return {"params": {
        "Dense_0": {"kernel": _linear_on_pooled(sd["box_head.fc1.weight"],
                                                pool_hw, channels),
                    "bias": sd["box_head.fc1.bias"]},
        "Dense_1": {"kernel": _linear(sd["box_head.fc2.weight"]),
                    "bias": sd["box_head.fc2.bias"]},
        "Dense_2": {"kernel": _linear(roll_w), "bias": roll_b},
        "Dense_3": {"kernel": _linear(sd["box_predictor.bbox_pred.weight"]),
                    "bias": sd["box_predictor.bbox_pred.bias"]},
    }}


def convert_detector_checkpoint(path_or_dict, num_classes,
                                stage_sizes=(3, 4, 6, 3),
                                seed_variables=None):
    """A GTR-style R50-FPN detector checkpoint -> the ``ClipDetector``
    variables ``{'params': {backbone, fpn, rpn, box_head},
    'batch_stats': {backbone}}``; with ``seed_variables`` (a tree of the
    same layout) the converted tree is grafted onto it with
    :func:`load_pretrain` and ``(variables, report)`` is returned.  The
    pooled bin count and channels come from the checkpoint (``fc1``'s
    input is bins^2 x the FPN width)."""
    sd = load_torch_state_dict(path_or_dict)
    prefix = ("backbone.bottom_up."
              if any(k.startswith("backbone.bottom_up.") for k in sd) else "")
    trunk = convert_resnet(sd, stage_sizes=stage_sizes, prefix=prefix)
    fpn = convert_fpn(sd)
    rpn = convert_rpn_head(sd)
    channels = fpn["params"]["lateral_0"]["kernel"].shape[-1]
    in_dim = sd["roi_heads.box_head.fc1.weight"].shape[1]
    pool_hw = int(round((in_dim // channels) ** 0.5))
    head = convert_box_head(sd, num_classes, pool_hw=pool_hw,
                            channels=channels)
    converted = {
        "params": {"backbone": trunk["params"], "fpn": fpn["params"],
                   "rpn": rpn["params"], "box_head": head["params"]},
        "batch_stats": {"backbone": trunk["batch_stats"]},
    }
    if seed_variables is None:
        return converted
    return load_pretrain(seed_variables, converted)


def load_gtr_checkpoint(pipe_or_detector, path_or_dict):
    """Load a GTR-style state_dict (a path or a mapping) into a
    ``ClipDetector``, or into an ``AmodalPipeline``'s detector (its
    expander keeps its weights: GTR has none).  The trunk's depth and the
    class count come from the detector.  An int8 trunk takes each conv's
    kernel as its ``qkernel`` (the same HWIO array; JAX's
    ``load_pretrain`` would leave ``qkernel`` at its init).  Raises on
    any missing, unexpected or mis-shaped entry.  Returns the
    detector."""
    det = getattr(pipe_or_detector, "detector", pipe_or_detector)
    tree = convert_detector_checkpoint(
        path_or_dict, det.num_classes,
        stage_sizes=det.backbone.stage_sizes)
    flat = {}
    for key, value in flatten(tree).items():
        collection, top, *path = key.split("/")
        if det.backbone.int8 and top == "backbone" and path[-2:] == [
                "Conv_0", "kernel"]:
            path = path[:-2] + ["qkernel"]
        flat["/".join(["detector", collection, top, *path])] = value
    holder = nn.Module()
    holder.detector = det
    weights.load_into(holder, flat)
    return det


def convert_siamese_checkpoint(path_or_dict, model=None, seed_variables=None):
    """A pysot tracker checkpoint -> ``(variables, report)``: its trunk
    (``backbone.``) and necks grafted with :func:`load_pretrain` onto
    ``seed_variables`` (a ``SiameseTracker``'s variable tree), or onto
    ``model``'s own weights where no tree is given; the heads keep the
    seed's weights."""
    if seed_variables is None:
        seed_variables = unflatten(weights.flat_variables(model))
    sd = load_torch_state_dict(path_or_dict)
    trunk = convert_resnet(sd, prefix="backbone.")
    necks = convert_adjust_necks(sd)
    pretrained = {
        "params": {"backbone": trunk["params"], **necks["params"]},
        "batch_stats": {"backbone": trunk["batch_stats"],
                        **necks["batch_stats"]},
    }
    return load_pretrain(seed_variables, pretrained)


def load_siamese_checkpoint(model, path_or_dict):
    """Load a pysot tracker checkpoint's trunk and necks into a
    ``SiameseTracker`` (:func:`convert_siamese_checkpoint` onto its own
    weights); returns the report."""
    variables, report = convert_siamese_checkpoint(path_or_dict, model)
    weights.load_variables(model, flatten(variables))
    return report
