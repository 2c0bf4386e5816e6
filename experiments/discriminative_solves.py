"""The discriminative trackers' solves and host work, measured outside the
tests (the numbers behind the bounds of ``tests/test_torch_port_{
discriminative,deep_trackers}.py``, ``chip_smoke.py``'s DISC constants and
PERF.md's entries on the discriminative trackers).

    python experiments/discriminative_solves.py ops      # CPU
    python experiments/discriminative_solves.py flops    # CPU, meta tensors
    python experiments/discriminative_solves.py eco      # CPU (+ JAX: --jax)
    python experiments/discriminative_solves.py bounds   # CPU, needs JAX
    python experiments/discriminative_solves.py dimp     # needs a card

- ``ops``: the ops a dimp_deep frame dispatches (a ``TorchDispatchMode``
  count), split into the trunk, the IoUNet ascent and a re-optimization
  frame's extra; at a 64 px crop, since the count does not depend on the
  crop's size (ResNet-50's full depth, ``(3, 4, 6, 3)``).
- ``flops``: ``torch.utils.flop_counter`` on meta tensors for the feature
  trunks at full width (ResNet-50 to layer3 on a 288² crop, to layer2 on
  one and three 144² crops).
- ``eco``: ECO's first-frame joint {filter, projection} solve at its
  defaults (search 96, filter 15) on the tests' textured sequence, f32
  against float64 from one PCA seed (``--jax``: JAX's f32 solve too).
- ``bounds``: the tests' Gauss-Newton inputs (ECO's factorized residual on
  seeds 0-3, DiMP's ``train_filter`` on 3 samples): JAX's and the port's
  f32 solutions against a float64 run.
- ``dimp``: DiMP's first solve at full width on the seeded dimp_deep
  features of ``chip_smoke.py``'s sequence, f32 and float64, on the card
  and on the CPU.
"""

import math
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from torch_port_fixtures import textured_target_frames  # noqa: E402

from tao_amodal_torch.ops.optimization import gauss_newton_cg  # noqa: E402
from tao_amodal_torch.trackers import discriminative as disc  # noqa: E402


def host(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, np.float64)


def rel(got, want):
    got, want = host(got), host(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def classify64(feats, filt):
    """DiMP's ``classify`` in the inputs' dtype (the port's casts to f32)."""
    b, h, w, c = feats.shape
    k = filt.shape[0]
    x = feats.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    wt = filt.permute(2, 0, 1)[None].expand(b, c, k, k).reshape(b * c, 1, k,
                                                                  k)
    return F.conv2d(x, wt, groups=b * c).reshape(b, c, h - k + 1,
                                                 w - k + 1).sum(1)


def dimp_solve(feat, label, dtype):
    """``train_filter``'s 5 x 8 solve in ``dtype``."""
    f, y = feat.to(dtype)[None], label.to(dtype)[None]
    k = 4
    return gauss_newton_cg(
        lambda w: {"data": classify64(f, w) - y, "reg": 0.1 * w},
        torch.zeros(k, k, f.shape[-1], dtype=dtype, device=f.device), 5, 8)


def count_ops():
    from torch.utils._python_dispatch import TorchDispatchMode

    from tao_amodal_torch.models.dimp import refine_box_ascent
    from tao_amodal_torch.trackers.factory import build_tracker

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    frames, gt = textured_target_frames(10, 240, 320, 1, size=(40, 30),
                                        speed=(4, 1))
    t = build_tracker("dimp_deep", search_size=64, device="cpu")
    t.init(frames[0], gt[0])
    per = []
    for k in range(1, 9):
        update = t.state.frame % t.update_interval == 0
        with Count() as c:
            t.update(frames[k])
        per.append((c.n, update))
    plain = [n for n, u in per if not u]
    extra = [n for n, u in per if u][0] - plain[0]
    with Count() as trunk:
        feat = t.extract(torch.zeros(64, 64, 3))
    with Count() as ascent:
        refine_box_ascent(t.iou_net, feat, t.state.mod_vec,
                          torch.tensor([20.0, 20.0, 44.0, 40.0]), 5, 0.5,
                          1.0 / 16)
    print(f"dimp_deep ops a frame: {plain[0]} (every plain frame: "
          f"{sorted(set(plain))}); the trunk {trunk.n}, the ascent "
          f"{ascent.n}; a re-optimization frame adds {extra}")


def count_flops():
    from torch.utils.flop_counter import FlopCounterMode

    from tao_amodal_torch.models.backbones import ResNet

    for stage, n, px in ((3, 1, 288), (2, 3, 144), (2, 1, 144)):
        m = ResNet(out_stages=(stage,)).to("meta").eval()
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            m(torch.empty(n, 3, px, px, device="meta"))
        print(f"ResNet-50 to stage {stage}, {n} x {px}^2: "
              f"{fc.get_total_flops() / 1e9:.2f} GFLOP")


def eco_solve(with_jax):
    from tao_amodal_torch.trackers.eco import EcoTracker
    from tao_amodal_torch.trackers.siamrpn import crop_subwindow

    frames, gt = textured_target_frames(4, 120, 160, 3, size=(34, 30),
                                        speed=(7, 3))
    t = EcoTracker(device="cpu")
    image, box = torch.from_numpy(frames[0]), torch.from_numpy(gt[0])
    center = box[:2] + box[2:] / 2
    crop_sz = torch.sqrt(torch.prod(box[2:])) * t.area_scale
    crop = crop_subwindow(image, center, crop_sz, t.P, image.float().mean(
        (0, 1)))
    feats = t.feature_fn(disc.augment_init_samples(crop)) * t.window
    proj0 = disc.pca_projection(feats, t.cdim)
    y = disc.gaussian_label((t.S, t.S), t.y_center,
                            t.label_sigma(box[2:], crop_sz))
    labels0 = y.expand(feats.shape[0], t.S, t.S)

    def run(dtype):
        f, p0, lab = feats.to(dtype), proj0.to(dtype), labels0.to(dtype)

        def residual(p):
            resp = disc.correlate(f @ p["proj"], p["filt"])
            return {"data": (resp - lab) / math.sqrt(7.0),
                    "reg_f": 0.1 * p["filt"],
                    "reg_p": 0.01 * (p["proj"] - p0)}

        return gauss_newton_cg(residual, {
            "proj": p0, "filt": torch.zeros(t.fsz, t.fsz, t.cdim,
                                            dtype=dtype)}, 4, 6)

    (p32, l32), (p64, l64) = run(torch.float32), run(torch.float64)
    print(f"ECO's joint solve at its defaults: the port's f32 filter "
          f"{rel(p32['filt'], p64['filt']):.3f} of its largest from "
          f"float64, the projection {rel(p32['proj'], p64['proj']):.2e}; "
          f"losses f32 {l32.numpy()}, float64 {l64.numpy()}")
    if with_jax:
        import jax
        import jax.numpy as jnp

        from tao_amodal_tpu.ops.optimization import gauss_newton_cg as jgn
        from tao_amodal_tpu.trackers import discriminative as jd

        jax.config.update("jax_platforms", "cpu")
        jf, jp0 = jnp.asarray(feats.numpy()), jnp.asarray(proj0.numpy())
        jl = jnp.asarray(labels0.numpy())

        def jres(p):
            resp = jd.correlate(jf @ p["proj"], p["filt"])
            return {"data": (resp - jl) / jnp.sqrt(7.0),
                    "reg_f": jnp.sqrt(1e-2) * p["filt"],
                    "reg_p": jnp.sqrt(1e-4) * (p["proj"] - jp0)}

        jp, jloss = jgn(jres, {"proj": jp0,
                               "filt": jnp.zeros((t.fsz, t.fsz, t.cdim))},
                        4, 6)
        print(f"  JAX's f32 filter from the same seed: "
              f"{rel(np.asarray(jp['filt']), p64['filt']):.3f} of its "
              f"largest from float64; losses {np.asarray(jloss)}")


def test_bounds():
    import jax
    import jax.numpy as jnp

    from test_torch_port_deep_trackers import GN_RTOL as dimp_tol
    from test_torch_port_discriminative import (
        GN_RTOL,
        _factorized,
        _factorized_inputs,
    )

    from tao_amodal_torch.models import dimp as pd
    from tao_amodal_tpu.ops.optimization import gauss_newton_cg as jgn
    from tao_amodal_tpu.models import dimp as jdm
    from tao_amodal_tpu.trackers.discriminative import correlate as jc

    jax.config.update("jax_platforms", "cpu")
    for seed in range(4):
        feats, labels, proj0, filt0 = _factorized_inputs(seed)
        out, losses = {}, {}
        for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
            t = lambda a: torch.from_numpy(np.asarray(a)).to(dt)  # noqa: E731
            out[name], losses[name] = gauss_newton_cg(
                _factorized(torch, disc.correlate, t(feats), t(labels),
                            t(proj0)), {"proj": t(proj0), "filt": t(filt0)},
                4, 6)
        want, wl = jgn(_factorized(jnp, jc, jnp.asarray(feats),
                                   jnp.asarray(labels), jnp.asarray(proj0)),
                       {"proj": jnp.asarray(proj0),
                        "filt": jnp.asarray(filt0)}, 4, 6)
        print(f"ECO's factorized residual, seed {seed} (held at {GN_RTOL}): "
              f"losses JAX against the port {rel(losses['f32'], wl):.2e}; "
              + ", ".join(
                  f"{k}: JAX {rel(want[k], out['f64'][k]):.2e}, port "
                  f"{rel(out['f32'][k], out['f64'][k]):.2e} from float64, "
                  f"each other {rel(out['f32'][k], want[k]):.2e}"
                  for k in ("proj", "filt")))
    rs = np.random.RandomState(5)
    feats = rs.randn(3, 10, 10, 8).astype(np.float32)
    yy, xx = np.mgrid[:7, :7]
    labels = np.stack([np.exp(-((yy - r) ** 2 + (xx - c) ** 2) / 8.0)
                       for r, c in ((3, 3), (2, 4), (4, 3))]).astype(
                           np.float32)
    f32 = pd.train_filter(torch.from_numpy(feats), torch.from_numpy(labels),
                          (4, 4, 8))[0]
    f64 = gauss_newton_cg(
        lambda w: {"data": classify64(torch.from_numpy(feats).double(), w)
                   - torch.from_numpy(labels).double(), "reg": 0.1 * w},
        torch.zeros(4, 4, 8, dtype=torch.float64), 5, 8)[0]
    jf = jdm.train_filter(jnp.asarray(feats), jnp.asarray(labels),
                          (4, 4, 8))[0]
    print(f"DiMP's train_filter (held at {dimp_tol}): JAX "
          f"{rel(np.asarray(jf), f64):.2e}, port {rel(f32, f64):.2e} from "
          f"float64, each other {rel(f32, np.asarray(jf)):.2e}")


def dimp_full_width():
    from tao_amodal_torch.models.dimp import train_filter
    from tao_amodal_torch.trackers.deep_features import make_dimp_extractor
    from tao_amodal_torch.trackers.dimp import gaussian_label
    from tao_amodal_torch.trackers.factory import build_tracker
    from tao_amodal_torch.trackers.siamrpn import crop_subwindow
    from tao_amodal_torch.utils.weights import flat_variables

    if not torch.cuda.is_available():
        raise SystemExit("dimp: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0))
    frames, gt = textured_target_frames(2, 480, 640, seed=1, size=(80, 60),
                                        speed=(8, 2), grow=1.01)
    dimp = build_tracker("dimp_deep")
    ext_cpu, _ = make_dimp_extractor(
        variables=flat_variables(dimp.extract.model), device="cpu")
    f0, box = torch.from_numpy(frames[0]), torch.from_numpy(gt[0])
    center = box[:2] + box[2:] / 2
    crop = crop_subwindow(f0, center, torch.sqrt(torch.prod(box[2:])) * 5.0,
                          288, f0.float().mean((0, 1)))
    feat = ext_cpu(crop)
    label = gaussian_label((15, 15), torch.full((2,), 7.0))
    runs = {"card f32": train_filter(feat[None].cuda(), label[None].cuda(),
                                     (4, 4, 1024)),
            "CPU f32": train_filter(feat[None], label[None], (4, 4, 1024)),
            "card f64": dimp_solve(feat.cuda(), label.cuda(), torch.float64),
            "CPU f64": dimp_solve(feat, label, torch.float64)}
    first = float(runs["CPU f64"][1][0])
    for name, (filt, losses) in runs.items():
        print(f"{name}: losses {losses.cpu().numpy()}; the filter "
              f"{rel(filt, runs['CPU f64'][0]):.3e} of its largest from the "
              f"CPU's float64 run")
    for a, b in (("card f32", "CPU f32"), ("card f32", "card f64"),
                 ("CPU f32", "CPU f64"), ("card f64", "CPU f64")):
        d = float((runs[a][1].double().cpu() - runs[b][1].double().cpu())
                  .abs().max())
        print(f"losses {a} against {b}: {d / first:.2e} of the first loss")


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode == "ops":
        count_ops()
    elif mode == "flops":
        count_flops()
    elif mode == "eco":
        eco_solve("--jax" in sys.argv)
    elif mode == "bounds":
        test_bounds()
    elif mode == "dimp":
        dimp_full_width()
    else:
        raise SystemExit(__doc__)
