"""Long-term Siamese tracking (SiamRPN-LT).

Port of ``tao_amodal_tpu/trackers/longterm.py``: when the best score
drops below ``confidence_low`` the tracker is lost and searches a widened
window (the state's size times ``redetect_scale``, no window prior)
without updating its state, until a re-detection is confident again.
The lost test reads the score on the host each frame, as JAX's does.
"""

from __future__ import annotations

import torch

from tao_amodal_torch.trackers.siamrpn import (
    SiamConfig,
    SiamRPNTracker,
    make_siamrpn_step,
)


class SiamRPNLTTracker(SiamRPNTracker):
    """``model`` None builds a seeded three-level
    :class:`~tao_amodal_torch.models.siamese.SiameseTracker` on
    ``device``."""

    def __init__(self, model=None, cfg: SiamConfig = SiamConfig(),
                 confidence_low=0.85, redetect_scale=2.0, seed=0,
                 device="cuda"):
        if model is None:
            from tao_amodal_torch.trackers.factory import seeded_model

            model = seeded_model(seed, device)
        super().__init__(model, cfg)
        self.confidence_low = confidence_low
        self.redetect_scale = redetect_scale
        self.lost = False
        # Re-detection: the same crop sizes, no window prior.
        _, self._wide_step = make_siamrpn_step(
            model, cfg._replace(window_influence=0.0))

    def update(self, image):
        image = torch.as_tensor(image, device=self.model.device)
        if not self.lost:
            self.state, (box, score) = self.step_fn(self.state, image)
            if float(score) < self.confidence_low:
                self.lost = True
            return box.cpu().numpy(), float(score)

        wide = self.state._replace(size=self.state.size
                                   * self.redetect_scale)
        new_state, (box, score) = self._wide_step(wide, image)
        if float(score) >= self.confidence_low:
            self.lost = False
            self.state = new_state._replace(
                size=new_state.size / self.redetect_scale)
        if not self.lost:
            return box.cpu().numpy(), float(score)
        cur = self.state
        return (torch.cat([cur.center - cur.size / 2, cur.size]).cpu()
                .numpy(), float(score))
