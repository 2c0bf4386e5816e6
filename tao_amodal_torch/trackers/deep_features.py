"""Deep-backbone feature plugs for the online trackers.

Port of ``tao_amodal_tpu/trackers/deep_features.py`` (the reference's
``pytracking/features/deep.py``, ``tracker/dimp/dimp.py:80-155``): the
tracker crops at ``sample_size = S * stride`` pixels and a ResNet's
stride-``stride`` stage maps the crop onto the ``S x S`` response grid.
The trunk is :class:`tao_amodal_torch.models.backbones.ResNet` (no
stage fused), its input normalized with ImageNet's mean and deviation
times 255, in inference mode; it stops after the stage it returns.

Weights: seeded from ``seed`` (a ``torch.Generator`` on the device,
Flax's default initializers) unless ``variables`` gives JAX's flat
``ResNet`` variables (``params/...``, ``batch_stats/...``, as
:func:`~tao_amodal_torch.utils.weights.load_flat` reads them), and
likewise ``iou_variables`` for the IoUNet.  Each ``build_deep_*`` runs on
``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

# ImageNet normalization, the convention trained torch backbones expect.
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)

_STAGE_STRIDE = {1: 4, 2: 8, 3: 16, 4: 32}


def _seeded(module, seed, variables):
    from tao_amodal_torch.utils import weights

    if variables is None:
        dev = next(module.parameters()).device
        weights.random_init_(module, torch.Generator(device=dev).manual_seed(
            seed))
    else:
        weights.load_variables(module, variables)
    return module.eval()


def make_resnet_feature_fn(search_size, out_stage=2, variables=None,
                           stage_sizes=(3, 4, 6, 3), seed=0, device="cuda"):
    """A ``crops [..., P, P, 3] -> feats [..., S, S, C]`` ResNet closure
    (NHWC, f32), ``P = search_size * stride(out_stage)`` so the stage's
    output lands on the ``S x S`` grid (reference ATOM: a 288 px crop to
    an 18 x 18 layer3 map).

    Returns ``(feature_fn, model, sample_size)``: ``model`` is the
    :class:`~tao_amodal_torch.models.backbones.ResNet` that holds the
    weights (JAX returns its variables).  ``feature_fn`` runs without
    grad (tracking); ``feature_fn.with_grad`` is the same function under
    the caller's grad mode (meta-training, :mod:`tao_amodal_torch.train.
    dimp_loss`).
    """
    from tao_amodal_torch.models.backbones import ResNet

    stride = _STAGE_STRIDE[out_stage]
    sample_size = search_size * stride
    model = _seeded(ResNet(stage_sizes=stage_sizes, out_stages=(out_stage,)
                           ).to(device), seed, variables)
    mean = torch.tensor(_MEAN).to(device) * 255.0
    std = torch.tensor(_STD).to(device) * 255.0

    def features(crops):
        lead = crops.shape[:-3]
        x = (crops.to(torch.float32) - mean) / std
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
        feats = model(x)[0].permute(0, 2, 3, 1)
        return feats.reshape(*lead, *feats.shape[1:])

    feature_fn = torch.no_grad()(features)
    feature_fn.model = model
    feature_fn.with_grad = features
    return feature_fn, model, sample_size


def make_dimp_extractor(search_size=288, feat_stride=16, variables=None,
                        stage_sizes=(3, 4, 6, 3), seed=0, device="cuda"):
    """The backbone embedding of :class:`~tao_amodal_torch.trackers.dimp.
    DimpTracker`: ``crop [S, S, 3] -> feat [S/stride, S/stride, C]`` (the
    reference's classification features, ``dimp.py:80-98``).

    Returns ``(extractor_fn, model)``."""
    out_stage = {v: k for k, v in _STAGE_STRIDE.items()}[feat_stride]
    fn, model, _ = make_resnet_feature_fn(
        search_size // feat_stride, out_stage=out_stage, variables=variables,
        stage_sizes=stage_sizes, seed=seed, device=device)
    return fn, model


def build_deep_atom(search_size=18, out_stage=2, variables=None,
                    stage_sizes=(3, 4, 6, 3), seed=0, device="cuda",
                    **kwargs):
    """ATOM on ResNet features (the reference runs layer3 at 18 x 18;
    the default here is the stride-8 stage on the same grid)."""
    from tao_amodal_torch.trackers.atom import AtomTracker

    fn, _, sample = make_resnet_feature_fn(
        search_size, out_stage=out_stage, variables=variables,
        stage_sizes=stage_sizes, seed=seed, device=device)
    kwargs.setdefault("filter_size", 5)
    return AtomTracker(feature_fn=fn, search_size=search_size,
                       sample_size=sample, device=device, **kwargs)


def build_deep_eco(search_size=18, out_stage=2, variables=None,
                   stage_sizes=(3, 4, 6, 3), seed=0, device="cuda",
                   **kwargs):
    """ECO on ResNet features (the reference ECO's deep branch)."""
    from tao_amodal_torch.trackers.eco import EcoTracker

    fn, _, sample = make_resnet_feature_fn(
        search_size, out_stage=out_stage, variables=variables,
        stage_sizes=stage_sizes, seed=seed, device=device)
    kwargs.setdefault("filter_size", 5)
    return EcoTracker(feature_fn=fn, search_size=search_size,
                      sample_size=sample, device=device, **kwargs)


def seeded_iou_net(channels, seed, device="cuda"):
    """An :class:`~tao_amodal_torch.models.dimp.IoUNet` over ``channels``
    feature channels with seeded weights."""
    from tao_amodal_torch.models.dimp import IoUNet

    return _seeded(IoUNet(channels, device=device), seed, None)


def build_deep_dimp(search_size=288, feat_stride=16, variables=None,
                    iou_variables=None, stage_sizes=(3, 4, 6, 3), seed=0,
                    device="cuda", **kwargs):
    """DiMP with a ResNet classification branch and an IoUNet (the
    reference's ``dimp.py`` with ``ltr/models/tracking/dimpnet.py``)."""
    from tao_amodal_torch.models.dimp import IoUNet
    from tao_amodal_torch.trackers.dimp import DimpTracker

    extractor, model = make_dimp_extractor(
        search_size, feat_stride, variables=variables,
        stage_sizes=stage_sizes, seed=seed, device=device)
    if iou_variables is None:
        iou_net = seeded_iou_net(model.out_channels()[0], seed + 1, device)
    else:
        iou_net = IoUNet.from_variables(iou_variables, device=device)
    return DimpTracker(extractor, iou_net, search_size=search_size,
                       feat_stride=feat_stride, device=device, **kwargs)
