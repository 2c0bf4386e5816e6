"""The port's Siamese training held against the JAX package on the CPU:
the config tree and its merges (``--opts`` stores strings, as JAX's
does), anchor targets and augmentations on JAX's own draws, the Siamese
loss with SiamMask's mask loss, both samplers, the disk-fed pairs, the
synthetic pairs, and one whole ``build_siamese_training`` step at the
train CLI's ``--smoke`` crops (64/128) on the bridged weights of
``tests/test_torch_port_siamese.py``.  JAX's own Siamese training tests
are slow-marked, so this file runs the JAX side itself; the train CLI's
tests are in ``test_torch_port_sot_train_cli.py``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from tao_amodal_tpu import config as jconfig
from tao_amodal_tpu.cli.train_cli import (
    build_siamese_training as jax_build,
)
from tao_amodal_tpu.cli.train_cli import (
    synthetic_pair_batch as jax_pair_batch,
)
from tao_amodal_tpu.data import sot_train as jsot_train
from tao_amodal_tpu.data.sot_datasets import (
    load_sot_dataset as jax_load_sot,
)
from tao_amodal_tpu.train import augment as jaug
from tao_amodal_tpu.train import sampler as jsampler
from tao_amodal_tpu.train.anchor_target import (
    assign_anchor_targets as jax_targets,
)
from tao_amodal_tpu.train.siamese_loss import siamese_loss as jax_loss
from tao_amodal_tpu.utils.checkpoint import flatten
from tao_amodal_torch import config as tconfig
from tao_amodal_torch.cli.train_cli import (
    build_siamese_training,
    synthetic_pair_batch,
)
from tao_amodal_torch.data import sot_train as tsot_train
from tao_amodal_torch.data.sot_datasets import load_sot_dataset
from tao_amodal_torch.train import augment as taug
from tao_amodal_torch.train import sampler as tsampler
from tao_amodal_torch.train.anchor_target import (
    anchor_draws,
    assign_anchor_targets,
)
from tao_amodal_torch.train.optim import apply_updates
from tao_amodal_torch.train.siamese_loss import siamese_loss
from tao_amodal_torch.utils.weights import flax_layout, load_variables
from torch_port_fixtures import one_torch_thread, siamese_model

module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

EX, INST = 64, 128
# Loss terms: the same f32 ops in another summation order.
LOSS_RTOL = 1e-5
# A gradient within 1e-4 of its leaf's largest |gradient| (the train
# tests' bound: two f32 ResNet-50 backward passes).
GRAD_TOL = 1e-4
# Updated leaves: within 1e-6 of the leaf's largest |value|.
OPT_TOL = 1e-6
# Anchor targets' deltas, weights and IoU: within 1e-6 (absolute; one
# f32 op apart at most).
TARGET_ATOL = 1e-6
# Augmentations: within 1e-5 of the image's largest |value| (the blur's
# and the gray's sums in another order).
AUG_TOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _smoke_cfg(module):
    cfg = module.default_config()
    cfg.track.exemplar_size = EX
    cfg.track.instance_size = INST
    cfg.track.base_size = 0
    return cfg


# -- config -----------------------------------------------------------------


def test_config_tree_and_merges_match_jax(tmp_path):
    """The default tree, YAML, dict and dotted-path merges and
    ``Settings`` equal JAX's; unknown keys raise ``KeyError``; and, as in
    JAX, ``merge_from_list`` stores what it is given: ``--opts
    train.epochs 1`` sets the string ``'1'``."""
    assert tconfig.default_config().to_dict() == \
        jconfig.default_config().to_dict()
    path = tmp_path / "exp.yaml"
    path.write_text("train:\n  epochs: 3\n  start_lr: 0.005\n"
                    "track:\n  penalty_k: 0.1\nmesh:\n  data: 2\n")
    opts = ["train.epochs", "1", "track.ratios", (0.5, 1.0),
            "sort.max_age", 4]
    got, want = [], []
    for mod, out in ((tconfig, got), (jconfig, want)):
        cfg = mod.default_config().merge_from_file(str(path))
        cfg.merge_from_dict({"detector": {"num_dets": 32}})
        cfg.merge_from_list(opts)
        out.append(cfg.to_dict())
        for bad in (lambda: cfg.merge_from_list(["train.nope", 1]),
                    lambda: cfg.merge_from_dict({"nope": 1}),
                    lambda: cfg.merge_from_dict({"train": {"nope": 1}})):
            with pytest.raises(KeyError):
                bad()
    assert got == want
    assert got[0]["train"]["epochs"] == "1"
    assert got[0]["train"]["start_lr"] == 0.005
    assert got[0]["detector"]["num_dets"] == 32
    os.environ["TAO_AMODAL_WORKSPACE"] = str(tmp_path / "ws")
    try:
        ts, js = tconfig.env_settings(), jconfig.env_settings()
    finally:
        del os.environ["TAO_AMODAL_WORKSPACE"]
    assert vars(ts) == vars(js)
    assert ts.checkpoint_dir == str(tmp_path / "ws" / "checkpoints")


# -- anchor targets ---------------------------------------------------------


def _jax_anchor_draws(rng, B, N):
    """JAX's uniforms inside ``assign_anchor_targets`` for the CLI's
    ``jax.random.split(rng, B)`` keys."""
    pos, neg = [], []
    for key in jax.random.split(rng, B):
        r_pos, r_neg = jax.random.split(key)
        pos.append(np.asarray(jax.random.uniform(r_pos, (N,))))
        neg.append(np.asarray(jax.random.uniform(r_neg, (N,))))
    return {"pos": torch.from_numpy(np.stack(pos)),
            "neg": torch.from_numpy(np.stack(neg))}


def _jax_targets(anchors, boxes, rng):
    rngs = jax.random.split(rng, len(boxes))
    return jax.vmap(lambda b, r: jax_targets(jnp.asarray(anchors), b, r))(
        jnp.asarray(boxes), rngs)


def _target_boxes(instance):
    """Boxes that exercise every branch: an anchor's size on and off a
    grid point, large, thin, at the border, and a negative pair's
    zero-size box.  JAX's anchors (the tracker's) are centred on 0, the
    crop's centre, so boxes near 0 get positives; the CLI's boxes are in
    crop pixels, centred on ``instance / 2``."""
    c = instance / 2
    return np.asarray([[0, 0, 64, 64], [12, -8, 90, 45],
                       [c, c, 150, 120], [c - 30, c, 12, 70],
                       [8, instance - 6, 30, 30], [c, c, 0, 0]],
                      np.float32)


@pytest.mark.parametrize("sizes", [(EX, INST, 0), (127, 255, 8)])
def test_anchor_targets_match_jax_on_its_draws(sizes):
    """Labels, positive and negative masks equal JAX's on JAX's own
    uniforms; deltas, weights and IoU within TARGET_ATOL; the budgets
    hold (at most 16 positives, 64 samples)."""
    from tao_amodal_torch.trackers.siamrpn import (
        SiamConfig,
        generate_anchors,
        score_size,
    )

    ex, inst, base = sizes
    scfg = SiamConfig(exemplar_size=ex, instance_size=inst, base_size=base)
    anchors = generate_anchors(scfg, ss=score_size(scfg))
    boxes = _target_boxes(inst)
    rng = jax.random.PRNGKey(5)
    want = _jax_targets(anchors, boxes, rng)
    got = assign_anchor_targets(torch.from_numpy(anchors),
                                torch.from_numpy(boxes),
                                _jax_anchor_draws(rng, len(boxes),
                                                  len(anchors)))
    assert set(got) == set(want)
    np.testing.assert_array_equal(_np(got["label"]), np.asarray(
        want["label"]))
    for k in ("delta", "pos_weight", "neg_weight", "iou"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=TARGET_ATOL, err_msg=k)
    label = _np(got["label"])
    assert ((label == 1).sum(1) <= 16).all()
    assert ((label >= 0).sum(1) <= 64).all()
    assert (label[:2] == 1).any(1).all() and (label[-1] != 1).all()


def test_anchor_draws_are_uniform_and_seeded():
    """The port's draws: two ``[B, N]`` uniforms on [0, 1), the same for
    the same seed."""
    d1 = anchor_draws(3, 50, torch.Generator().manual_seed(1))
    d2 = anchor_draws(3, 50, torch.Generator().manual_seed(1))
    assert set(d1) == {"pos", "neg"}
    for k in d1:
        assert d1[k].shape == (3, 50) and torch.equal(d1[k], d2[k])
        assert float(d1[k].min()) >= 0 and float(d1[k].max()) < 1
    assert not torch.equal(d1["pos"], d1["neg"])


# -- the Siamese loss ---------------------------------------------------------


@pytest.mark.parametrize("S,Hs", [(5, 64), (25, 255)])
def test_siamese_loss_matches_jax_with_the_mask_loss(S, Hs):
    """Every term of ``siamese_loss`` within LOSS_RTOL of JAX's on the
    same outputs and targets, the mask loss included (its nearest resize
    at JAX's half-pixel centres and its patches, padded where the
    windows pass the border, at 5 x 5 on a 64 image)."""
    rs = np.random.RandomState(S)
    B, A, P = 2, 5, 63
    outputs = {"cls": rs.randn(B, S, S, 2 * A).astype(np.float32) * 2,
               "loc": rs.randn(B, S, S, 4 * A).astype(np.float32),
               "mask": rs.randn(B, S, S, P * P).astype(np.float32) * 3}
    N = A * S * S
    label = rs.choice([-1, 0, 1], (B, N), p=[0.8, 0.15, 0.05])
    pos = (label == 1).astype(np.float32)
    neg = (label == 0).astype(np.float32)
    mask = np.zeros((B, Hs, Hs), np.float32)
    mask[0, Hs // 4:Hs // 2, Hs // 3:Hs - 5] = 1
    mask[1, 3:Hs // 2, 3:Hs // 2] = 1
    targets = {"label": label.astype(np.int32),
               "delta": rs.randn(B, N, 4).astype(np.float32),
               "pos_weight": pos / np.maximum(pos.sum(1, keepdims=True), 1),
               "neg_weight": neg / np.maximum(neg.sum(1, keepdims=True), 1),
               "mask_label": mask}
    want_total, want = jax_loss(
        {k: jnp.asarray(v) for k, v in outputs.items()},
        {k: jnp.asarray(v) for k, v in targets.items()})
    got_total, got = siamese_loss(
        {k: torch.from_numpy(v) for k, v in outputs.items()},
        {k: torch.from_numpy(v) for k, v in targets.items()})
    assert set(got) == set(want) == {"cls_loss", "loc_loss", "mask_loss"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(want_total),
                               rtol=LOSS_RTOL)
    assert float(got["mask_loss"]) > 0


# -- augmentations ------------------------------------------------------------


def _jax_aug_draws(keys):
    """JAX's draws inside ``augment_pair`` for each key, as the port's
    ``augment_draws`` dict."""
    out = {k: [] for k in ("shift", "scale", "flip", "color", "gray",
                           "blur", "template_color")}
    for key in keys:
        r = jax.random.split(key, 6)
        r1, r2, _ = jax.random.split(r[0], 3)
        out["shift"].append(jax.random.uniform(r1, (2,), minval=-64,
                                               maxval=64))
        out["scale"].append(1.0 + jax.random.uniform(
            r2, (2,), minval=-0.18, maxval=0.18))
        out["flip"].append(jax.random.uniform(r[1], ()))
        out["color"].append(1.0 + jax.random.uniform(
            r[2], (3,), minval=-0.1, maxval=0.1))
        out["gray"].append(jax.random.uniform(r[3], ()))
        out["blur"].append(jax.random.uniform(r[4], ()))
        out["template_color"].append(1.0 + jax.random.uniform(
            r[5], (3,), minval=-0.1, maxval=0.1))
    return {k: torch.from_numpy(np.stack([np.asarray(a) for a in v]))
            for k, v in out.items()}


def _aug_keys():
    """Keys whose draws apply, and skip, each of the flip, gray and blur
    (the gray applies at 5 %)."""
    keys, seen = [], set()
    for i in range(400):
        key = jax.random.PRNGKey(i)
        d = _jax_aug_draws([key])
        tag = (bool(d["flip"][0] < 0.5), bool(d["gray"][0] < 0.05),
               bool(d["blur"][0] < 0.18))
        if tag not in seen:
            seen.add(tag)
            keys.append(key)
        if len(seen) == 8:
            break
    assert len(seen) >= 6, seen
    return keys


def _aug_inputs(B, seed=0, hw=(40, 48)):
    rs = np.random.RandomState(seed)
    search = rs.uniform(0, 255, (B, *hw, 3)).astype(np.float32)
    template = rs.uniform(0, 255, (B, 24, 24, 3)).astype(np.float32)
    box = np.stack([rs.uniform(10, 30, B), rs.uniform(10, 30, B),
                    rs.uniform(5, 20, B), rs.uniform(5, 20, B)],
                   1).astype(np.float32)
    return template, search, box


def _close(got, want, what):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= AUG_TOL * np.abs(want).max(), (what, err)


def test_augmentations_match_jax_on_its_draws():
    """Each augmentation, batched, on JAX's own draws (shift and scale,
    flip, color, gray, blur, each applied and skipped), and the whole
    ``augment_pair``, within AUG_TOL of the image's largest; boxes too."""
    keys = _aug_keys()
    B = len(keys)
    template, search, box = _aug_inputs(B)
    d = _jax_aug_draws(keys)
    ts, tb = torch.from_numpy(search), torch.from_numpy(box)
    jax_each = {"shift_scale": [], "hflip": [], "color": [], "gray": [],
                "blur": [], "pair": []}
    for i, key in enumerate(keys):
        r = jax.random.split(key, 6)
        x, b = jnp.asarray(search[i]), jnp.asarray(box[i])
        jax_each["shift_scale"].append(jaug.shift_scale(x, b, r[0]))
        jax_each["hflip"].append(jaug.hflip(x, b, r[1]))
        jax_each["color"].append(jaug.color_jitter(x, r[2]))
        jax_each["gray"].append(jaug.grayscale(x, r[3]))
        jax_each["blur"].append(jaug.blur(x, r[4]))
        jax_each["pair"].append(jaug.augment_pair(
            jnp.asarray(template[i]), x, b, key))
    got = {
        "shift_scale": taug.shift_scale(ts, tb, d["shift"], d["scale"]),
        "hflip": taug.hflip(ts, tb, d["flip"]),
        "color": taug.color_jitter(ts, d["color"]),
        "gray": taug.grayscale(ts, d["gray"]),
        "blur": taug.blur(ts, d["blur"]),
        "pair": taug.augment_pair(torch.from_numpy(template), ts, tb, d),
    }
    for name, outs in jax_each.items():
        if isinstance(outs[0], tuple):
            for j, part in enumerate(zip(*outs)):
                _close(got[name][j], np.stack(part), f"{name}[{j}]")
        else:
            _close(got[name], np.stack(outs), name)


def test_augment_draws_are_seeded_and_in_range():
    """The port's draws for ``augment_pair``: shapes, ranges, seeded."""
    d = taug.augment_draws(64, torch.Generator().manual_seed(3))
    e = taug.augment_draws(64, torch.Generator().manual_seed(3))
    assert all(torch.equal(d[k], e[k]) for k in d)
    assert d["shift"].shape == (64, 2) and d["color"].shape == (64, 3)
    assert float(d["shift"].abs().max()) <= 64
    assert float((d["scale"] - 1).abs().max()) <= 0.18
    assert float((d["color"] - 1).abs().max()) <= 0.1
    for k in ("flip", "gray", "blur"):
        assert d[k].shape == (64,) and 0 <= float(d[k].min())
        assert float(d[k].max()) < 1


# -- samplers and data -------------------------------------------------------


class _Source:
    def __init__(self, tracks, frames):
        self.num_tracks = tracks
        self.frames = frames

    def track_frames(self, t):
        return [{"frame": i} for i in range(self.frames + t)]


def test_samplers_match_jax():
    """``TrackPairSampler`` and ``SequenceSampler`` over two weighted
    sources give JAX's samples for the same seeds."""
    srcs = [_Source(4, 12), _Source(3, 5)]
    outs = []
    for mod in (tsampler, jsampler):
        pairs = mod.TrackPairSampler(srcs, weights=[2, 1], frame_range=3,
                                     neg_prob=0.3, seed=7)
        seqs = mod.SequenceSampler(srcs, weights=[1, 3],
                                   num_train_frames=3, num_test_frames=4,
                                   max_gap=2, seed=7)
        it = iter(pairs)
        outs.append(([next(it) for _ in range(60)],
                     [seqs.sample() for _ in range(40)]))
    assert outs[0] == outs[1]
    pos = [p for p in outs[0][0] if not p["is_negative"]]
    assert pos and len(pos) < 60
    assert all(abs(p["template"][2] - p["search"][2]) <= 3 for p in pos)


def test_tao_track_source_matches_jax(tmp_path):
    """``TaoTrackSource`` over the port's ``TaoDataset``: the JAX
    adapter's track ids and frames, and the sampler's pairs over it."""
    from fixture_gen import make_fixture
    from tao_amodal_tpu.data.tao import TaoDataset as JaxTao
    from tao_amodal_torch.data.tao import TaoDataset

    gt, _ = make_fixture(seed=3, num_videos=2, frames_per_video=6)
    path = tmp_path / "gt.json"
    path.write_text(json.dumps(gt))
    ts = tsampler.TaoTrackSource(TaoDataset(str(path)))
    js = jsampler.TaoTrackSource(JaxTao(str(path)))
    assert ts.num_tracks == js.num_tracks > 0
    assert ts.track_ids == js.track_ids
    for t in range(ts.num_tracks):
        assert ts.track_frames(t) == js.track_frames(t)
    got = tsampler.TrackPairSampler([ts], seed=1)
    want = jsampler.TrackPairSampler([js], seed=1)
    assert [got.sample() for _ in range(20)] == \
        [want.sample() for _ in range(20)]


@pytest.fixture(scope="module")
def lasot_root(tmp_path_factory):
    """``tests/test_sot_train.py``'s LaSOT layout: three sequences of six
    frames of a red square moving on a rolled background."""
    root = tmp_path_factory.mktemp("lasot")
    rng = np.random.RandomState(0)
    for cls, sid in (("cat", 1), ("cat", 2), ("dog", 1)):
        d = root / cls / f"{cls}-{sid}"
        (d / "img").mkdir(parents=True)
        gt = []
        base = rng.randint(0, 255, (96, 128, 3), np.uint8)
        for t in range(6):
            img = np.roll(base, 3 * t, axis=1)
            img[40:70, 30 + 3 * t:60 + 3 * t] = (250, 10, 10)
            Image.fromarray(img).save(d / "img" / f"{t:08d}.jpg")
            gt.append([30 + 3 * t, 40, 30, 30])
        np.savetxt(str(d / "groundtruth.txt"), np.asarray(gt, float),
                   delimiter=",", fmt="%.1f")
    return str(root)


def test_disk_pairs_match_jax(lasot_root):
    """``SotSequenceSource``, ``load_pair`` and ``pair_batch_iter`` (half
    the pairs negative) over a LaSOT tree give JAX's arrays exactly; the
    target sits at the search crop's centre; a negative pair's box has
    zero size."""
    sources = {}
    for name, mod, load in (("torch", tsot_train, load_sot_dataset),
                            ("jax", jsot_train, jax_load_sot)):
        src = mod.SotSequenceSource(load("lasot", lasot_root))
        sampler = (tsampler if name == "torch" else jsampler
                   ).TrackPairSampler([src], frame_range=5, neg_prob=0.5,
                                      seed=1)
        it = mod.pair_batch_iter(sampler, [src], 4, exemplar_size=EX,
                                 instance_size=INST)
        sources[name] = (src, [next(it) for _ in range(3)])
    (tsrc, got), (jsrc, want) = sources["torch"], sources["jax"]
    assert tsrc.num_tracks == jsrc.num_tracks == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"template", "search", "box"}
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    boxes = np.concatenate([b["box"] for b in got])
    assert (boxes[:, :2] == INST / 2).all()
    assert (boxes[:, 2] == 0).any() and (boxes[:, 2] > 0).any()
    t, x, b = tsot_train.load_pair(tsrc.track_frames(0)[0],
                                   tsrc.track_frames(0)[3],
                                   exemplar_size=EX, instance_size=INST)
    assert t.shape == (EX, EX, 3) and x.shape == (INST, INST, 3)
    centre = x[INST // 2 - 5:INST // 2 + 5, INST // 2 - 5:INST // 2 + 5]
    assert centre[..., 0].mean() > 1.6 * centre[..., 1].mean()


def test_synthetic_pairs_match_jax():
    """The CLI's synthetic pairs, byte for byte from the same seed, at the
    smoke's crops and at JAX's defaults."""
    for cfg_t, cfg_j in ((_smoke_cfg(tconfig), _smoke_cfg(jconfig)),
                         (tconfig.default_config(),
                          jconfig.default_config())):
        got = synthetic_pair_batch(np.random.RandomState(4), 3, cfg_t)
        want = jax_pair_batch(np.random.RandomState(4), 3, cfg_j)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# -- one whole training step -----------------------------------------------


@pytest.fixture(scope="module")
def siamese_step():
    """The bridged weights (``test_torch_port_siamese.py``'s, without the
    mask heads) in JAX's ``build_siamese_training`` step, one step on a
    batch of 2 synthetic pairs and one key; JAX's loss as that step
    composes it, its value and gradient jitted in f32 and in float64 (the
    oracle; on the f32 targets of the same draws)."""
    from tao_amodal_torch.utils.torch_convert import unflatten
    from tao_amodal_torch.utils.weights import flat_variables
    from tao_amodal_tpu.models.siamese import SiameseTracker
    from tao_amodal_tpu.parallel.mesh import make_mesh, shard_batch
    from tao_amodal_tpu.trackers.siamrpn import (
        SiamConfig,
        generate_anchors,
    )

    tm = siamese_model(0, "cpu", EX, INST, with_mask=True,
                       with_refine=True)
    flat = {k: v for k, v in flat_variables(tm).items()
            if "/mask_head/" not in k and "/refine_head/" not in k}
    jv = jax.tree_util.tree_map(jnp.asarray, unflatten(flat))
    cfg = _smoke_cfg(jconfig)
    batch = jax_pair_batch(np.random.RandomState(0), 2, cfg)
    rng = jax.random.PRNGKey(11)

    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    jstep, (_, opt_state) = jax_build(cfg, mesh)
    (new_params, _), metrics = jstep((jv, opt_state),
                                     shard_batch(mesh, batch), rng)

    model = SiameseTracker(num_levels=3)
    scfg = SiamConfig(exemplar_size=EX, instance_size=INST, base_size=0)
    out = jax.eval_shape(lambda: model.apply(
        jv, template=jnp.asarray(batch["template"]),
        search=jnp.asarray(batch["search"]), mode="train"))
    anchors = generate_anchors(scfg, ss=out["cls"].shape[1])
    targets = jax.vmap(lambda b, r: jax_targets(anchors, b, r))(
        jnp.asarray(batch["box"]), jax.random.split(rng, 2))

    def grads_in(dtype, params, targets):
        def loss_fn(p):
            outputs = model.apply(
                p, template=jnp.asarray(batch["template"], dtype),
                search=jnp.asarray(batch["search"], dtype), mode="train")
            return jax_loss(outputs, targets, cls_weight=1.0,
                            loc_weight=1.2)

        (loss, terms), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        return loss, terms, {k: np.asarray(v, np.float64)
                             for k, v in flatten(grads).items()}

    loss, terms, grads = grads_in(jnp.float32, jv, targets)
    with jax.enable_x64():
        def f64(a):
            return (jnp.asarray(a, jnp.float64)
                    if jnp.issubdtype(a.dtype, jnp.floating) else a)

        _, _, grads64 = grads_in(jnp.float64,
                                 jax.tree_util.tree_map(f64, jv),
                                 jax.tree_util.tree_map(f64, targets))
    return {"flat": flat, "batch": batch, "rng": rng, "loss": loss,
            "terms": terms, "grads": grads, "grads64": grads64,
            "metrics": metrics, "params": flatten(new_params),
            "anchors": np.asarray(anchors)}


def _port_step(flat):
    step, state = build_siamese_training(_smoke_cfg(tconfig), device="cpu")
    load_variables(step.model, flat)
    return step, state


def _grad_errors(names, grads, want):
    """Each leaf's max |grads - want| over want's largest |value|."""
    out = {}
    for name, g in zip(names, grads):
        a = flax_layout(name, g).astype(np.float64) if torch.is_tensor(g) \
            else g
        w = want[name]
        assert a.shape == w.shape, name
        out[name] = np.abs(a - w).max() / max(np.abs(w).max(), 1e-30)
    return out


def test_siamese_step_loss_and_gradients_match_jax(siamese_step):
    """One ``build_siamese_training`` step's loss on the bridged weights
    and JAX's draws: each term within LOSS_RTOL of JAX's.  Gradients:
    this model's f32 gradients are ill-conditioned (JAX's own f32
    gradients lie up to about 8 % of a leaf's largest from its float64
    ones, and 0.4 % at the median, as ReLU inputs near 0 change side), so
    every leaf (BatchNorm statistics included) is held to the float64
    oracle: the port's worst leaf within GRAD_TOL or 1.5 times JAX f32's
    worst, and its median leaf within twice JAX f32's median."""
    s = siamese_step
    step, _ = _port_step(s["flat"])
    draws = _jax_anchor_draws(s["rng"], 2, len(s["anchors"]))
    loss, terms, grads = step.loss_and_grads(s["batch"], draws)
    np.testing.assert_allclose(float(loss), float(s["loss"]),
                               rtol=LOSS_RTOL)
    assert set(terms) == set(s["terms"]) == {"cls_loss", "loc_loss"}
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(s["terms"][k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    names = step.flax_names()
    assert sorted(names) == sorted(s["grads64"])
    port = _grad_errors(names, grads, s["grads64"])
    jax32 = _grad_errors(names, [s["grads"][n] for n in names],
                         s["grads64"])
    worst = max(GRAD_TOL, 1.5 * max(jax32.values()))
    bad = {n: e for n, e in port.items() if not e <= worst}
    assert not bad, (worst, sorted(bad.items(), key=lambda x: -x[1])[:5])
    assert np.median(list(port.values())) <= 2 * np.median(
        list(jax32.values()))
    # The statistics get gradients (JAX trains them), but for the loc
    # heads': no pair of this batch has a positive anchor.
    stats = [n for n in names if n.startswith("batch_stats/")
             and "loc" not in n]
    assert stats and all(np.abs(s["grads64"][n]).max() > 0 for n in stats)


def test_siamese_step_update_matches_jax(siamese_step):
    """The whole step against JAX's train step: ``loss`` and the terms
    within LOSS_RTOL; ``grad_norm`` within LOSS_RTOL of the float64
    oracle's or twice JAX f32's distance from it; the optimizer
    (clip, weight decay, momentum, the warmup rate) fed JAX's f32
    gradients moves every leaf within OPT_TOL of optax; the step's own
    updated leaves within OPT_TOL plus the rate times twice JAX f32's
    worst gradient error (the gradients' conditioning, above)."""
    from tao_amodal_tpu.train import optim as joptim

    s = siamese_step
    step, state = _port_step(s["flat"])
    names = step.flax_names()
    draws = _jax_anchor_draws(s["rng"], 2, len(s["anchors"]))
    _, metrics = step.run(state, s["batch"], draws)
    assert set(metrics) == set(s["metrics"])
    for k in ("loss", "cls_loss", "loc_loss"):
        np.testing.assert_allclose(float(metrics[k]),
                                   float(s["metrics"][k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    norm64 = np.sqrt(sum(np.sum(g * g) for g in s["grads64"].values()))
    jax_err = abs(float(s["metrics"]["grad_norm"]) - norm64)
    assert abs(float(metrics["grad_norm"]) - norm64) <= max(
        LOSS_RTOL * norm64, 2 * jax_err)
    tr = jconfig.default_config().train
    sched = joptim.warmup_log_schedule(
        tr.start_lr / 10, tr.start_lr, tr.warmup_epochs * 50, tr.start_lr,
        tr.end_lr, 2 * 50)
    lr0 = float(sched(0))
    spread = max(_grad_errors(names, [s["grads"][n] for n in names],
                              s["grads64"]).values())
    for n, t in zip(names, step.leaves):
        a, w = flax_layout(n, t), np.asarray(s["params"][n])
        bound = (OPT_TOL * np.abs(w).max()
                 + lr0 * 2 * spread * np.abs(s["grads64"][n]).max())
        assert np.abs(a - w).max() <= bound, n

    # The optimizer alone, on equal gradients.
    fresh, fresh_state = _port_step(s["flat"])
    jopt = joptim.make_optimizer(sched, weight_decay=tr.weight_decay,
                                 momentum=tr.momentum,
                                 clip_norm=tr.grad_clip)
    jgrads = {n: jnp.asarray(s["grads"][n], jnp.float32) for n in names}
    jparams = {n: jnp.asarray(flax_layout(n, t))
               for n, t in zip(names, fresh.leaves)}
    want = jax.jit(lambda g, p: optax.apply_updates(
        p, jopt.update(g, jopt.init(p), p)[0]))(jgrads, jparams)
    tgrads = [torch.from_numpy(np.ascontiguousarray(_torch_layout(
        n, np.asarray(s["grads"][n], np.float32)))) for n in names]
    u, _ = fresh.optimizer.update(tgrads, fresh_state.opt_state,
                                  fresh.leaves)
    apply_updates(fresh.leaves, u)
    for n, t in zip(names, fresh.leaves):
        a, w = flax_layout(n, t), np.asarray(want[n])
        assert np.abs(a - w).max() <= OPT_TOL * np.abs(w).max(), n


def _torch_layout(name, a):
    """A JAX leaf's value in the port's layout (the inverse of
    ``flax_layout``)."""
    if name.endswith("/kernel"):
        return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    return a


def test_siamese_step_draws_its_targets_on_the_model_device(siamese_step):
    """``step(state, batch, rng)`` draws the anchor noise from ``rng`` on
    the model's device (``anchor_draws`` on a generator seeded with it):
    its metrics equal ``run`` on those draws, and are finite; another
    seed draws other noise."""
    s = siamese_step
    n = len(s["anchors"])
    runs = []
    for call in ("step", "run"):
        step, state = _port_step(s["flat"])
        if call == "step":
            _, m = step(state, s["batch"], 1)
        else:
            _, m = step.run(state, s["batch"], anchor_draws(
                2, n, torch.Generator(device="cpu").manual_seed(1)))
        runs.append({k: float(v) for k, v in m.items()})
    assert runs[0] == runs[1]
    assert all(np.isfinite(v) for v in runs[0].values())
    other = anchor_draws(2, n, torch.Generator().manual_seed(2))
    assert not torch.equal(other["pos"], anchor_draws(
        2, n, torch.Generator().manual_seed(1))["pos"])
