"""Tracker construction by name.

Port of ``tao_amodal_tpu/trackers/factory.py``: one entry point builds a
tracker family from a config and a checkpoint, so the harnesses stay
tracker-agnostic.  The Siamese builders take ``params``, the flat
variables of the JAX ``SiameseTracker`` (``params/...`` and
``batch_stats/...`` keys, as ``save_pytree`` writes them and
:func:`~tao_amodal_torch.utils.weights.load_flat` reads them), or seed
Flax-default random weights from ``seed``; they build on ``device``, the
card unless the caller asks for the CPU.  The discriminative trackers
(ECO, ATOM, DiMP and their deep-feature builders) are not ported yet.
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
    """Known names: siamrpn, siamrpn_lt, siammask, sort (and eco, atom,
    dimp and their ``_deep`` forms, which raise: not ported)."""
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


def _not_ported(name):
    def build(**kwargs):
        raise NotImplementedError(
            f"the '{name}' tracker is not ported to tao_amodal_torch yet: "
            f"the discriminative trackers are the second half of ROADMAP "
            f"Queue A #11")
    return build


for _name in ("eco", "atom", "dimp", "atom_deep", "eco_deep", "dimp_deep"):
    register_tracker(_name)(_not_ported(_name))


@register_tracker("sort")
def _build_sort(**kwargs):
    from tao_amodal_torch.trackers.sort import Sort

    return Sort(**kwargs)
