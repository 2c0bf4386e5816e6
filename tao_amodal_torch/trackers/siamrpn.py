"""SiamRPN++ tracking on the card.

Port of ``tao_amodal_tpu/trackers/siamrpn.py``.  A frame is the sub-window
crop (a bilinear gather whose out-of-image samples take the channel
average), the Siamese model, the anchor decode, the scale and ratio
penalties, the Hanning window, the argmax and the smoothed state update,
all on the tensors' device: a step makes no host sync, so a whole clip
(:func:`track_clip`) runs without one, as JAX's ``lax.scan`` does.

The hyperparameters ``(penalty_k, window_influence, lr)`` are a tensor
argument of one shared core, so the fixed-config step
(:func:`make_siamrpn_step`) and the hyperparameter sweep
(:func:`make_siamrpn_hp_sweep`, the grid as a batch axis: every cell's
crop of a frame in one forward, the template embedded once) run the same
code.  The decode (:func:`decode`) is a function of the model's outputs,
so it can be held to JAX's on identical outputs.  Anchors and the
window are built on the host exactly as JAX builds them and moved to the
device once, before the first frame.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from tao_amodal_torch.trackers.base import Tracker

f32 = torch.float32


class SiamConfig(NamedTuple):
    """Tracking hyperparameters (reference ``config.py`` TRACK/ANCHOR)."""

    exemplar_size: int = 127
    instance_size: int = 255
    base_size: int = 8
    context_amount: float = 0.5
    stride: int = 8
    ratios: tuple = (0.33, 0.5, 1.0, 2.0, 3.0)
    scales: tuple = (8,)
    penalty_k: float = 0.04
    window_influence: float = 0.44
    lr: float = 0.4


def score_size(cfg: SiamConfig):
    """Nominal response size (the reference formula); the trackers take
    the real one from the model (:meth:`~tao_amodal_torch.models.siamese.
    SiameseTracker.response_size`)."""
    return ((cfg.instance_size - cfg.exemplar_size) // cfg.stride + 1
            + cfg.base_size)


def generate_anchors(cfg: SiamConfig, ss=None):
    """Anchor grid ``[A*S*S, 4]`` (cx, cy, w, h), f32 numpy, anchor-major
    (JAX's ``generate_anchors``: ``int()`` truncation included)."""
    if ss is None:
        ss = score_size(cfg)
    anchors = []
    for r in cfg.ratios:
        for s in cfg.scales:
            base = cfg.stride * s
            w = int(np.sqrt(base * base / r))
            h = int(w * r)
            anchors.append([w, h])
    anchors = np.array(anchors, np.float32)
    ori = -(ss // 2) * cfg.stride
    xx, yy = np.meshgrid(ori + cfg.stride * np.arange(ss),
                         ori + cfg.stride * np.arange(ss))
    grid = np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float32)
    out = np.zeros((len(anchors), ss * ss, 4), np.float32)
    out[:, :, :2] = grid[None]
    out[:, :, 2:] = anchors[:, None, :]
    return out.reshape(-1, 4)


def hanning_window(cfg: SiamConfig, ss=None):
    """The cosine window ``[A*S*S]``, f32 numpy (``np.hanning``)."""
    if ss is None:
        ss = score_size(cfg)
    h = np.hanning(ss)
    win = np.outer(h, h).reshape(-1)
    return np.tile(win, len(cfg.ratios) * len(cfg.scales)).astype(np.float32)


def crop_subwindow(image, center, crop_size, out_size, pad_value):
    """Square crops of a tensor size -> ``out_size`` x ``out_size``, f32.

    ``image`` ``[H, W, 3]`` (uint8 or f32), ``center`` ``[..., 2]`` (x,
    y), ``crop_size`` ``[...]``, ``pad_value`` ``[3]`` -> ``[..., out,
    out, 3]``.  Output pixel u samples the image at ``center -
    crop_size/2 + (u + 0.5) * crop_size/out_size - 0.5`` bilinearly, and
    a neighbour outside the image takes ``pad_value`` (JAX's
    ``crop_subwindow``, in its f32 operation order).
    """
    H, W = image.shape[:2]
    flat = image.reshape(H * W, -1)
    u = torch.arange(out_size, dtype=f32, device=image.device) + 0.5
    scale = (crop_size / out_size)[..., None]
    half = (crop_size / 2)[..., None]
    xs = center[..., 0, None] - half + u * scale - 0.5       # [..., out]
    ys = center[..., 1, None] - half + u * scale - 0.5
    X = xs[..., None, :].expand(*xs.shape[:-1], out_size, out_size)
    Y = ys[..., :, None].expand(*ys.shape[:-1], out_size, out_size)
    x0 = torch.floor(X)
    y0 = torch.floor(Y)
    wx = (X - x0)[..., None]
    wy = (Y - y0)[..., None]

    def fetch(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = yi.clamp(0, H - 1).long()
        xc = xi.clamp(0, W - 1).long()
        vals = flat[yc * W + xc].to(f32)
        return torch.where(inb[..., None], vals, pad_value)

    f00 = fetch(y0, x0)
    f01 = fetch(y0, x0 + 1)
    f10 = fetch(y0 + 1, x0)
    f11 = fetch(y0 + 1, x0 + 1)
    return ((1 - wy) * ((1 - wx) * f00 + wx * f01)
            + wy * ((1 - wx) * f10 + wx * f11))


class SiamState(NamedTuple):
    center: torch.Tensor       # [..., 2] (cx, cy)
    size: torch.Tensor         # [..., 2] (w, h)
    channel_avg: torch.Tensor  # [3]
    zf: Any                    # the template features (a list of NHWC maps)


def _rdiv(a, t):
    """``a / t`` for a Python number ``a``, as one rounded division
    (PyTorch's ``a / t`` multiplies by the reciprocal)."""
    return torch.full_like(t, a) / t


def _window_sizes(size, cfg):
    """(s_z, scale_z, s_x) of a state's ``size`` ``[..., 2]``."""
    total = size[..., 0] + size[..., 1]
    w_z = size[..., 0] + cfg.context_amount * total
    h_z = size[..., 1] + cfg.context_amount * total
    s_z = torch.sqrt(w_z * h_z)
    return (s_z, _rdiv(cfg.exemplar_size, s_z),
            s_z * (cfg.instance_size / cfg.exemplar_size))


def decode(out, state, hp, image_hw, anchors, window, ss, cfg):
    """The step's math after the model: softmax scores, anchor decode
    (the ``exp`` clamped to [-10, 10]), penalties, window, argmax and
    the smoothed update, for a batch of N trackers.

    ``out``: the model's ``cls`` ``[N, ss, ss, 2A]`` and ``loc`` ``[N, ss,
    ss, 4A]``; ``state``: centers and sizes ``[N, 2]``; ``hp`` ``[N, 3]``
    (penalty_k, window_influence, lr).  Returns (center, size, box xywh
    ``[N, 4]``, score ``[N]``, best ``[N]``, the index of the chosen
    anchor-major cell)."""
    N = out["cls"].shape[0]
    A = len(cfg.ratios) * len(cfg.scales)
    cls = out["cls"].reshape(N, ss * ss, A, 2).float()
    e = torch.exp(cls - cls.amax(-1, keepdim=True))
    score = (e / e.sum(-1, keepdim=True))[..., 1]
    score = score.transpose(1, 2).reshape(N, -1)            # [N, A*ss*ss]
    loc = out["loc"].reshape(N, ss * ss, A, 4).float()
    loc = loc.transpose(1, 2).reshape(N, -1, 4)
    pred = torch.stack([
        loc[..., 0] * anchors[:, 2] + anchors[:, 0],
        loc[..., 1] * anchors[:, 3] + anchors[:, 1],
        torch.exp(loc[..., 2].clamp(-10.0, 10.0)) * anchors[:, 2],
        torch.exp(loc[..., 3].clamp(-10.0, 10.0)) * anchors[:, 3],
    ], dim=1)                                               # [N, 4, K]

    def change(r):
        return torch.maximum(r, _rdiv(1.0, r))

    def sz(w, h):
        pad = (w + h) * 0.5
        return torch.sqrt((w + pad) * (h + pad))

    size = state.size
    _, scale_z, _ = _window_sizes(size, cfg)
    penalty_k, wi, lr_k = hp[:, 0, None], hp[:, 1, None], hp[:, 2, None]
    s_c = change(sz(pred[:, 2], pred[:, 3])
                 / sz(size[:, 0, None] * scale_z[:, None],
                      size[:, 1, None] * scale_z[:, None]))
    r_c = change((size[:, 0] / size[:, 1])[:, None]
                 / (pred[:, 2] / pred[:, 3]))
    penalty = torch.exp(-(r_c * s_c - 1.0) * penalty_k)
    pscore = penalty * score
    pscore = pscore * (1 - wi) + window * wi
    best = torch.argmax(pscore, dim=1)                      # [N]

    pick = best[:, None]
    bbox = torch.gather(pred, 2, pick[:, None].expand(N, 4, 1))[..., 0]
    bbox = bbox / scale_z[:, None]
    best_score = torch.gather(score, 1, pick)[:, 0]
    lr = torch.gather(penalty, 1, pick)[:, 0] * best_score * lr_k[:, 0]
    cx = bbox[:, 0] + state.center[:, 0]
    cy = bbox[:, 1] + state.center[:, 1]
    width = size[:, 0] * (1 - lr) + bbox[:, 2] * lr
    height = size[:, 1] * (1 - lr) + bbox[:, 3] * lr
    H, W = image_hw
    cx = cx.clamp(0.0, W)
    cy = cy.clamp(0.0, H)
    width = width.clamp(10.0, W)
    height = height.clamp(10.0, H)
    box = torch.stack([cx - width / 2, cy - height / 2, width, height], 1)
    return (torch.stack([cx, cy], 1), torch.stack([width, height], 1),
            box, best_score, best)


class SiamCore:
    """The shared tracking core of one model and config: the response
    size (one shape probe of the model), the anchors and the window on
    the model's device, :meth:`init` and the batched :meth:`step`."""

    def __init__(self, model, cfg: SiamConfig = SiamConfig()):
        self.model, self.cfg = model, cfg
        self.device = model.device
        self.ss = model.response_size(cfg.exemplar_size, cfg.instance_size)
        self.anchors = torch.from_numpy(
            generate_anchors(cfg, ss=self.ss)).to(self.device)
        self.window = torch.from_numpy(
            hanning_window(cfg, ss=self.ss)).to(self.device)

    def hp(self):
        """``[3]`` (penalty_k, window_influence, lr) of the config, on the
        device."""
        cfg = self.cfg
        return torch.tensor([cfg.penalty_k, cfg.window_influence, cfg.lr],
                            dtype=f32, device=self.device)

    @torch.no_grad()
    def init(self, image, box_xywh):
        """First frame + xywh box -> the :class:`SiamState` (center and
        size ``[2]``)."""
        cfg = self.cfg
        image = torch.as_tensor(image, device=self.device)
        box = torch.as_tensor(box_xywh, dtype=f32, device=self.device)
        center = torch.stack([box[0] + (box[2] - 1) / 2,
                              box[1] + (box[3] - 1) / 2])
        size = box[2:4]
        total = size[0] + size[1]
        w_z = size[0] + cfg.context_amount * total
        h_z = size[1] + cfg.context_amount * total
        s_z = torch.round(torch.sqrt(w_z * h_z))
        channel_avg = image.to(f32).mean(dim=(0, 1))
        z_crop = crop_subwindow(image, center, s_z, cfg.exemplar_size,
                                channel_avg)
        zf = self.model(template=z_crop[None], mode="template")
        return SiamState(center, size, channel_avg, zf)

    def crops(self, state, image):
        """The N trackers' search crops of ``image`` ``[N, S, S, 3]`` and
        their sizes ``s_x`` (rounded) ``[N]``."""
        cfg = self.cfg
        _, _, s_x = _window_sizes(state.size, cfg)
        s_x = torch.round(s_x)
        return s_x, crop_subwindow(image, state.center, s_x,
                                   cfg.instance_size, state.channel_avg)

    @torch.no_grad()
    def search(self, state, image):
        """(``s_x``, the model's outputs on the N search crops)."""
        s_x, crops = self.crops(state, image)
        return s_x, self.model(search=crops, zf=state.zf, mode="track")

    @torch.no_grad()
    def step(self, state, image, hp):
        """One frame for N trackers: ``state`` centers and sizes ``[N,
        2]``, ``hp`` ``[N, 3]`` -> (new state, (box ``[N, 4]``, score
        ``[N]``))."""
        image = torch.as_tensor(image, device=self.device)
        _, out = self.search(state, image)
        center, size, box, score, _ = decode(
            out, state, hp, image.shape[:2], self.anchors, self.window,
            self.ss, self.cfg)
        return state._replace(center=center, size=size), (box, score)


def _batched(state):
    return state._replace(center=state.center[None], size=state.size[None])


def _single(state):
    return state._replace(center=state.center[0], size=state.size[0])


def make_siamrpn_step(model, cfg: SiamConfig = SiamConfig()):
    """``(init_fn, step_fn)`` of ``model`` (a
    :class:`~tao_amodal_torch.models.siamese.SiameseTracker`, on its
    device) at the hyperparameters of ``cfg``:
    ``init_fn(image, box_xywh) -> state`` and ``step_fn(state, image) ->
    (state, (box_xywh [4], score))``, tensors on the model's device."""
    core = SiamCore(model, cfg)
    hp0 = core.hp()[None]

    def step_fn(state, image):
        new, (box, score) = core.step(_batched(state), image, hp0)
        return _single(new), (box[0], score[0])

    step_fn.core = core
    return core.init, step_fn


def make_siamrpn_hp_sweep(model, cfg: SiamConfig = SiamConfig()):
    """The whole hyperparameter grid as a batch axis: N trackers advance
    in lockstep, each frame's N crops in one forward of the model, the
    template embedded once and shared (JAX's ``vmap`` over the grid).

    Returns ``sweep_fn(frames [T, H, W, 3], init_box, hp_grid [N, 3]) ->
    (boxes [N, T, 4], scores [N, T])``; no host sync inside."""
    core = SiamCore(model, cfg)

    def sweep_fn(frames, init_box, hp_grid):
        frames = torch.as_tensor(frames, device=core.device)
        hp_grid = torch.as_tensor(hp_grid, dtype=f32, device=core.device)
        N = hp_grid.shape[0]
        state = core.init(frames[0], init_box)
        state = state._replace(center=state.center.expand(N, 2),
                               size=state.size.expand(N, 2))
        boxes, scores = [], []
        for frame in frames[1:]:
            state, (box, score) = core.step(state, frame, hp_grid)
            boxes.append(box)
            scores.append(score)
        first = torch.as_tensor(init_box, dtype=f32,
                                device=core.device).expand(N, 1, 4)
        ones = torch.ones(N, 1, device=core.device)
        if not boxes:
            return first, ones
        return (torch.cat([first, torch.stack(boxes, 1)], 1),
                torch.cat([ones, torch.stack(scores, 1)], 1))

    sweep_fn.core = core
    return sweep_fn


def track_clip(init_fn, step_fn, frames, init_box):
    """Track through ``frames [T, H, W, 3]`` (a tensor on the model's
    device): (boxes ``[T, 4]``, scores ``[T]``), frame 0 the init box
    with score 1; no host sync between frames."""
    state = init_fn(frames[0], init_box)
    boxes, scores = [], []
    for frame in frames[1:]:
        state, out = step_fn(state, frame)
        boxes.append(out[0])
        scores.append(out[1])
    first = torch.as_tensor(init_box, dtype=f32, device=frames.device)[None]
    ones = torch.ones(1, device=frames.device)
    if not boxes:
        return first, ones
    return (torch.cat([first, torch.stack(boxes)]),
            torch.cat([ones, torch.stack(scores)]))


class SiamRPNTracker(Tracker):
    """The reference Tracker API over :func:`make_siamrpn_step`:
    ``update`` returns a numpy box and a float score each frame (a host
    sync a frame, as JAX's does)."""

    def __init__(self, model, cfg: SiamConfig = SiamConfig()):
        self.model, self.cfg = model, cfg
        self.init_fn, self.step_fn = make_siamrpn_step(model, cfg)
        self.state = None

    def init(self, image, box):
        self.state = self.init_fn(image, np.asarray(box, np.float32))

    def update(self, image):
        self.state, (box, score) = self.step_fn(self.state, image)
        return box.cpu().numpy(), float(score)
