"""Tracker construction by name.

Port of ``tao_amodal_tpu/trackers/factory.py``: one entry point builds a
tracker family from a config and a checkpoint, so the harnesses stay
tracker-agnostic.  The Siamese builders take ``params``, the flat
variables of the JAX ``SiameseTracker`` (``params/...`` and
``batch_stats/...`` keys, as ``save_pytree`` writes them and
:func:`~tao_amodal_torch.utils.weights.load_flat` reads them), or seed
Flax-default random weights from ``seed``.  The discriminative trackers
take JAX's keyword names: ``eco`` and ``atom`` their trackers' options
(pixel features by default), ``dimp`` a caller's ``extractor_fn`` (a
``ValueError`` without one, as in JAX), and ``atom_deep``, ``eco_deep``
and ``dimp_deep`` a seeded ResNet or its flat ``variables`` (and DiMP's
``iou_variables``).  Every tracker builds on ``device``, the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

import torch

_REGISTRY = {}


def register_tracker(name):
    def wrap(builder):
        _REGISTRY[name] = builder
        return builder
    return wrap


def build_tracker(name, **kwargs):
    """Known names: siamrpn, siamrpn_lt, siammask, eco, atom, dimp,
    atom_deep, eco_deep, dimp_deep, sort."""
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown tracker '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def seeded_model(seed=0, device="cuda", params=None, **kwargs):
    """A three-level :class:`~tao_amodal_torch.models.siamese.
    SiameseTracker` (``kwargs``: its options) on ``device`` with the
    variables ``params`` (a flat dict), or seeded random weights."""
    from tao_amodal_torch.models.siamese import SiameseTracker
    from tao_amodal_torch.utils import weights

    model = SiameseTracker(num_levels=3, device=device, **kwargs)
    if params is None:
        weights.random_init_(model, torch.Generator(
            device=model.device).manual_seed(seed))
    else:
        weights.load_variables(model, params)
    return model


@register_tracker("siamrpn")
def _build_siamrpn(params=None, config=None, seed=0, device="cuda",
                   **kwargs):
    from tao_amodal_torch.trackers.siamrpn import SiamConfig, SiamRPNTracker

    return SiamRPNTracker(seeded_model(seed, device, params, **kwargs),
                          config or SiamConfig())


@register_tracker("siamrpn_lt")
def _build_siamrpn_lt(params=None, config=None, seed=0, device="cuda",
                      **kwargs):
    from tao_amodal_torch.trackers.longterm import SiamRPNLTTracker
    from tao_amodal_torch.trackers.siamrpn import SiamConfig

    return SiamRPNLTTracker(seeded_model(seed, device, params),
                            config or SiamConfig(), **kwargs)


@register_tracker("siammask")
def _build_siammask(params=None, config=None, seed=0, device="cuda",
                    **kwargs):
    from tao_amodal_torch.trackers.siammask import SiamMaskTracker
    from tao_amodal_torch.trackers.siamrpn import SiamConfig

    model = seeded_model(seed, device, params, with_mask=True,
                         with_refine=True, **kwargs)
    return SiamMaskTracker(model, config or SiamConfig())


@register_tracker("eco")
def _build_eco(device="cuda", **kwargs):
    from tao_amodal_torch.trackers.eco import EcoTracker

    return EcoTracker(device=device, **kwargs)


@register_tracker("atom")
def _build_atom(device="cuda", **kwargs):
    from tao_amodal_torch.trackers.atom import AtomTracker

    return AtomTracker(device=device, **kwargs)


@register_tracker("dimp")
def _build_dimp(extractor_fn=None, iou_net=None, iou_variables=None,
                seed=0, device="cuda", **kwargs):
    """DiMP over a caller's ``extractor_fn``; the IoUNet is ``iou_net``,
    else built from ``iou_variables``, else seeded over the channels of
    the extractor's features."""
    from tao_amodal_torch.models.dimp import IoUNet
    from tao_amodal_torch.trackers.deep_features import seeded_iou_net
    from tao_amodal_torch.trackers.dimp import DimpTracker

    if extractor_fn is None:
        raise ValueError("dimp needs extractor_fn (+ iou_net vars)")
    if iou_net is None and iou_variables is not None:
        iou_net, iou_variables = IoUNet.from_variables(
            iou_variables, device=device), None
    elif iou_net is None:
        S = kwargs.get("search_size", 288)
        probe = extractor_fn(torch.zeros(S, S, 3, device=device))
        iou_net = seeded_iou_net(probe.shape[-1], seed + 1, device)
    return DimpTracker(extractor_fn, iou_net, iou_variables, device=device,
                       **kwargs)


@register_tracker("atom_deep")
def _build_atom_deep(**kwargs):
    from tao_amodal_torch.trackers.deep_features import build_deep_atom

    return build_deep_atom(**kwargs)


@register_tracker("eco_deep")
def _build_eco_deep(**kwargs):
    from tao_amodal_torch.trackers.deep_features import build_deep_eco

    return build_deep_eco(**kwargs)


@register_tracker("dimp_deep")
def _build_dimp_deep(**kwargs):
    from tao_amodal_torch.trackers.deep_features import build_deep_dimp

    return build_deep_dimp(**kwargs)


@register_tracker("sort")
def _build_sort(**kwargs):
    from tao_amodal_torch.trackers.sort import Sort

    return Sort(**kwargs)
