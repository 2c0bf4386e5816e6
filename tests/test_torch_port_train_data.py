"""The port's training data, augmentation, trainer and weight export held
against the JAX package on the CPU: the synthetic batches, videos and
occluder bank byte for byte; ``paste_patch``, ``shrink_visible_box``
and ``paste_n_occlude_batch`` on JAX's own draws; the occluder bank's
resize up and down; the prefetch loader; the trainer's checkpoints,
resume and fail-safe retry; the ``.npz`` of trained weights read by
JAX's ``load_pytree`` and served by ``ClipDetector.apply``; and the
train CLI."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tao_amodal_tpu.cli.train_detector_cli import (
    synthetic_detection_batch as jax_detection_batch,
)
from tao_amodal_tpu.data import synth_video as jsynth
from tao_amodal_tpu.data.loader import PrefetchLoader as JaxPrefetchLoader
from tao_amodal_tpu.data.loader import stack_collate as jax_stack_collate
from tao_amodal_tpu.train import paste_n_occlude as jpno
from tao_amodal_tpu.utils.checkpoint import flatten, load_pytree
from tao_amodal_torch.cli.train_detector_cli import (
    main as train_main,
)
from tao_amodal_torch.cli.train_detector_cli import (
    synthetic_detection_batch,
)
from tao_amodal_torch.data import loader as tloader
from tao_amodal_torch.data import synth_video as tsynth
from tao_amodal_torch.train import paste_n_occlude as tpno
from tao_amodal_torch.train.loop import TrainConfig, Trainer
from tao_amodal_torch.utils.weights import (
    flax_layout,
    flax_names,
    save_flat,
)
from torch_port_fixtures import (
    jax_pipeline,
    one_torch_thread,
    random_clip,
    save_npz,
    torch_pipeline,
)

module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)


def _equal_trees(a, b):
    assert type(a) is type(b) or isinstance(a, np.ndarray)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


@pytest.mark.parametrize("hw,max_gt", [(64, 4), (512, 4), (96, 7)])
def test_synthetic_detection_batch_is_byte_equal(hw, max_gt):
    got = synthetic_detection_batch(np.random.RandomState(3), 3, hw, max_gt)
    want = jax_detection_batch(np.random.RandomState(3), 3, hw, max_gt)
    _equal_trees(got, want)


@pytest.mark.parametrize("augment", [False, True])
def test_synth_videos_and_training_batches_are_byte_equal(augment):
    """``make_synth_videos`` (5 categories: the extra hues too) and the
    batches ``training_batches`` samples from them, with and without
    augmentation."""
    kw = dict(seed=4, num_videos=2, frames_per_video=3, hw=64,
              tracks_per_video=4, num_categories=5)
    gt, frames = tsynth.make_synth_videos(**kw)
    jgt, jframes = jsynth.make_synth_videos(**kw)
    _equal_trees(gt, jgt)
    _equal_trees(frames, jframes)
    got = list(tsynth.training_batches(gt, frames, np.random.RandomState(1),
                                       2, max_gt=5, steps=3,
                                       augment=augment))
    want = list(jsynth.training_batches(jgt, jframes,
                                        np.random.RandomState(1), 2,
                                        max_gt=5, steps=3, augment=augment))
    _equal_trees(got, want)


def test_write_frames_writes_the_tao_layout(tmp_path):
    gt, frames = tsynth.make_synth_videos(seed=0, num_videos=1,
                                          frames_per_video=2, hw=32,
                                          tracks_per_video=2)
    tsynth.write_frames(gt, frames, str(tmp_path))
    from PIL import Image

    for im in gt["images"]:
        arr = np.asarray(Image.open(tmp_path / im["file_name"]))
        assert arr.tobytes() == frames[im["video_id"]][
            im["frame_index"]].tobytes()


def test_synthetic_occluder_bank_is_byte_equal():
    got = tpno.synthetic_occluder_bank(seed=2, num=5, patch_size=32,
                                       device="cpu")
    want = np.asarray(jpno.synthetic_occluder_bank(seed=2, num=5,
                                                   patch_size=32))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


def test_paste_patch_and_shrink_visible_box_match_jax():
    """One patch at a fractional center and scale over an image (a patch
    edge crossing the image edge), then the visible box of a target it
    covers in part, of one it covers whole and of one it misses."""
    rs = np.random.RandomState(0)
    image = rs.uniform(0, 255, (48, 40, 3)).astype(np.float32)
    patch = np.asarray(jpno.synthetic_occluder_bank(seed=1, num=1,
                                                    patch_size=16))[0]
    center = np.array([33.3, 20.7], np.float32)
    scale = np.float32(1.37)
    want_img, want_mask = jpno.paste_patch(jnp.asarray(image),
                                           jnp.asarray(patch),
                                           jnp.asarray(center), scale)
    got_img, got_mask = tpno.paste_patch(
        torch.from_numpy(image), torch.from_numpy(patch),
        torch.from_numpy(center), torch.tensor(scale))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    mask = np.asarray(want_mask)
    assert 0 < mask.sum() < mask.size
    boxes = np.array([[20.0, 10.0, 39.5, 30.0], [30.0, 18.0, 34.0, 22.0],
                      [0.0, 0.0, 6.0, 5.0], [25.0, 5.5, 38.0, 44.2]],
                     np.float32)
    got_b, got_v = tpno.shrink_visible_box(torch.from_numpy(boxes),
                                           torch.from_numpy(mask)[None])
    for i, box in enumerate(boxes):
        want_b, want_v = jpno.shrink_visible_box(jnp.asarray(box),
                                                 jnp.asarray(mask))
        np.testing.assert_array_equal(got_b[i].numpy(), np.asarray(want_b))
        assert float(got_v[i]) == float(want_v)


def jax_occluder_draws(k_paste, K, max_occluders=3, scale_range=(0.5, 1.5),
                       occlude_prob=0.8):
    """JAX's draws inside ``paste_n_occlude`` for ``k_paste``: ``do``,
    ``idx``, ``offset`` a occluder and the one ``scale`` (``keys[-1]``,
    which every occluder uses)."""
    keys = jax.random.split(k_paste, max_occluders * 4 + 1)
    do, idx, off = [], [], []
    for i in range(max_occluders):
        k1, k2, k3, k4 = keys[4 * i:4 * i + 4]
        do.append(jax.random.uniform(k1, ()) < occlude_prob)
        idx.append(jax.random.randint(k2, (), 0, K))
        off.append([jax.random.uniform(k, (), minval=-0.6, maxval=0.6)
                    for k in (k3, k4)])
    scale = jax.random.uniform(keys[-1], (), minval=scale_range[0],
                               maxval=scale_range[1])
    return {"do": do, "idx": idx, "offset": off, "scale": scale}


def jax_pno_draws(rng, valid, K):
    """JAX's draws inside ``paste_n_occlude_batch`` for ``rng``, as the
    port's ``draws``."""
    out = {"u": [], "do": [], "idx": [], "offset": [], "scale": []}
    for key, v in zip(jax.random.split(rng, valid.shape[0]), valid):
        k_pick, k_paste = jax.random.split(key)
        out["u"].append(jax.random.uniform(k_pick, v.shape))
        for k, d in jax_occluder_draws(k_paste, K).items():
            out[k].append(d)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


def test_paste_n_occlude_batch_matches_jax():
    """A training batch (one sample with no valid gt, which stays as it
    was) on JAX's draws: images, shrunk visible boxes, validity and
    visibility; and the one-sample ``paste_n_occlude``."""
    batch = synthetic_detection_batch(np.random.RandomState(0), 4, hw=96)
    batch["gt_valid"][2] = False
    bank = np.asarray(jpno.synthetic_occluder_bank(seed=0, num=4,
                                                   patch_size=32))
    rng = jax.random.PRNGKey(7)
    want = jpno.paste_n_occlude_batch(
        jnp.asarray(batch["images"]), jnp.asarray(batch["gt_boxes"]),
        jnp.asarray(batch["gt_amodal"]), jnp.asarray(batch["gt_valid"]),
        jnp.asarray(bank), rng)
    draws = jax_pno_draws(rng, batch["gt_valid"], len(bank))
    got = tpno.paste_n_occlude_batch(
        *(torch.from_numpy(batch[k]) for k in ("images", "gt_boxes",
                                                 "gt_amodal", "gt_valid")),
        torch.from_numpy(bank), draws)
    img, boxes, valid, vis = (np.asarray(w) for w in want)
    np.testing.assert_allclose(got[0].numpy(), img, rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(got[1].numpy(), boxes)
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_array_equal(got[3].numpy(), vis)
    assert (vis[batch["gt_valid"]] < 1).any()          # something occluded
    np.testing.assert_array_equal(got[0][2].numpy(), batch["images"][2])

    one = jpno.paste_n_occlude(jnp.asarray(batch["images"][0]),
                               jnp.asarray(batch["gt_amodal"][0, 0]),
                               jnp.asarray(bank), jax.random.PRNGKey(8))
    d = {k: torch.from_numpy(np.asarray(v)) for k, v in
         jax_occluder_draws(jax.random.PRNGKey(8), len(bank)).items()}
    got_one = tpno.paste_n_occlude(
        torch.from_numpy(batch["images"][0]),
        torch.from_numpy(batch["gt_amodal"][0, 0]), torch.from_numpy(bank),
        d["do"], d["idx"], d["offset"], d["scale"])
    np.testing.assert_allclose(got_one["image"].numpy(),
                               np.asarray(one["image"]), rtol=1e-6,
                               atol=1e-3)
    for k in ("modal_box", "visibility", "occlusion_mask"):
        np.testing.assert_array_equal(got_one[k].numpy(), np.asarray(one[k]))


@pytest.mark.parametrize("crop_hw,patch", [((40, 23), 16), ((9, 12), 32)])
def test_make_occluder_bank_matches_jax(crop_hw, patch):
    """Crops resized down (antialiased: JAX's triangle widened by the
    factor) and up, against ``jax.image.resize(method="linear")``; a
    mask of fewer than 4 pixels is skipped."""
    rs = np.random.RandomState(0)
    h, w = crop_hw
    img = rs.randint(0, 255, (h + 10, w + 8, 3)).astype(np.uint8)
    mask = np.zeros((h + 10, w + 8), bool)
    mask[3:3 + h, 5:5 + w] = rs.rand(h, w) < 0.7
    mask[3, 5] = mask[2 + h, 4 + w] = True
    tiny = np.zeros_like(mask)
    tiny[0, :3] = True
    pairs = [(img, mask), (img, tiny)]
    got = tpno.make_occluder_bank(pairs, patch_size=patch, device="cpu")
    want = np.asarray(jpno.make_occluder_bank(pairs, patch_size=patch))
    assert got.shape == want.shape == (1, patch, patch, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="no usable occluders"):
        tpno.make_occluder_bank([(img, tiny)], device="cpu")


def test_prefetch_loader_keeps_order_and_collates_as_jax():
    samples = [{"x": np.full((2,), i, np.int32), "y": np.float32(i)}
               for i in range(10)]
    got = list(tloader.PrefetchLoader(iter(samples),
                                      tloader.stack_collate, 3,
                                      num_workers=1))
    want = list(JaxPrefetchLoader(iter(samples), jax_stack_collate, 3,
                                  num_workers=1))
    _equal_trees(got, want)
    assert [b["y"].tolist() for b in got] == [[0, 1, 2], [3, 4, 5],
                                              [6, 7, 8]]
    fed = list(tloader.device_feed(iter(got), device="cpu"))
    assert [b["x"].tolist() for b in fed] == [b["x"].tolist() for b in got]
    assert all(isinstance(b["y"], torch.Tensor) for b in fed)


def test_prefetch_loader_raises_a_worker_failure():
    """A sample iterator that fails part way: the batches before the
    failure arrive in order, then the consumer gets its exception."""
    def samples():
        yield from range(4)
        raise RuntimeError("source broken")

    loader = tloader.PrefetchLoader(samples(), lambda s: s[0], 1,
                                    num_workers=1)
    got = []
    with pytest.raises(RuntimeError, match="source broken"):
        for item in loader:
            got.append(item)
    assert got == [0, 1, 2, 3]


def test_trainer_fail_safe_recovers(tmp_path):
    """A mid-training crash restores the latest checkpoint and
    continues (reference base_trainer.py:60-88 behavior)."""
    calls = {"n": 0}

    def step(state, batch, rng):
        return state + 1, {"loss": torch.tensor(0.5)}

    crash_once = {"armed": True}

    def data_iter(epoch):
        for i in range(3):
            if epoch == 1 and i == 1 and crash_once["armed"]:
                crash_once["armed"] = False
                raise RuntimeError("injected fault")
            calls["n"] += 1
            yield {"x": np.zeros(1)}

    trainer = Trainer(step, torch.zeros(()), data_iter,
                      TrainConfig(num_epochs=3, steps_per_epoch=3,
                                  checkpoint_dir=str(tmp_path),
                                  log_every=100, keep_checkpoints=2,
                                  fail_safe_retries=3))
    state = trainer.train()
    assert trainer.epoch == 3
    assert not crash_once["armed"]
    # The crash came after epoch 0's checkpoint; epoch 1 was retried.
    assert float(state) == 9
    assert sorted(trainer.checkpoints()) == [2, 3]


def test_trainer_fail_safe_restarts_from_the_initial_state(tmp_path):
    """A crash before the first checkpoint restarts from the pristine
    initial state, not the partly trained one."""
    crash_once = {"armed": True}

    def step(state, batch, rng):
        state.add_(1)                       # mutates the state in place
        return state, {"loss": torch.tensor(0.0)}

    def data_iter(epoch):
        for i in range(3):
            if i == 2 and crash_once["armed"]:
                crash_once["armed"] = False
                raise RuntimeError("injected fault")
            yield {}

    trainer = Trainer(step, torch.zeros(()), data_iter,
                      TrainConfig(num_epochs=1, steps_per_epoch=3,
                                  checkpoint_dir=str(tmp_path),
                                  log_every=100, fail_safe_retries=2))
    assert float(trainer.train()) == 3


def test_trainer_fail_safe_exhausts(tmp_path):
    def step(state, batch, rng):
        return state, {"loss": torch.tensor(0.0)}

    def data_iter(epoch):
        raise RuntimeError("always broken")
        yield  # pragma: no cover

    trainer = Trainer(step, torch.zeros(()), data_iter,
                      TrainConfig(num_epochs=1, steps_per_epoch=1,
                                  checkpoint_dir=str(tmp_path),
                                  fail_safe_retries=2))
    with pytest.raises(RuntimeError, match="always broken"):
        trainer.train()


def test_trained_weights_serve_in_jax(tmp_path):
    """``save_flat`` of a port pipeline whose weights moved (a training
    step's worth of noise, BatchNorm statistics too) is the ``.npz`` of
    JAX's ``save_pytree``: ``load_pytree`` reads every leaf bit for bit
    (JAX layouts), ``ClipDetector.apply`` serves it as the port's
    detector does (the detector parity test's bounds: boxes rtol 1e-4 +
    1e-3 px, scores 1e-5, classes equal), and the file loads back into
    the port unchanged."""
    pipe, variables = jax_pipeline(seed=1)
    tp = torch_pipeline(save_npz(tmp_path, variables))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in list(tp.parameters()) + [
                b for n, b in tp.named_buffers() if "running" in n]:
            t.add_(1e-2 * torch.randn(t.shape, generator=g))
    path = str(tmp_path / "trained.npz")
    save_flat(path, tp)
    restored = load_pytree(path)
    flat = flatten(restored)
    assert sorted(flat) == sorted(flatten(variables))
    sd = tp.state_dict()
    for name, key in flax_names(tp).items():
        assert flax_layout(key, sd[name]).tobytes() == np.asarray(
            flat[key]).tobytes(), key
    clip = random_clip(2)
    want = jax.jit(pipe.detector.apply)(restored["detector"],
                                        jnp.asarray(clip))
    with torch.no_grad():
        got = tp.detector(torch.from_numpy(clip))
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-5)
    np.testing.assert_array_equal(got["classes"].numpy(),
                                  np.asarray(want["classes"]))
    back = torch_pipeline(path)
    for (n, a), b in zip(tp.state_dict().items(),
                         back.state_dict().values()):
        assert torch.equal(a, b), n


def test_train_cli_trains_resumes_and_occludes(tmp_path):
    """``--smoke --cpu``: 2 epochs of 3 steps, a checkpoint an epoch;
    ``--resume`` after the last checkpoint is removed restores epoch 1
    and the state saved with it, and trains epoch 2 again; so does a
    ``--paste_n_occlude`` run.  Every weight stays finite."""
    args = ["--smoke", "--cpu", "--batch_size", "2", "--checkpoint_dir",
            str(tmp_path / "ck")]
    first = train_main(args)
    assert first.epoch == 2
    assert sorted(first.checkpoints()) == [1, 2]
    saved = torch.load(first.checkpoints()[1], weights_only=True)
    assert saved["epoch"] == 1
    assert set(saved["state"]) == {"model", "opt_state"}
    assert any("running_var" in k for k in saved["state"]["model"])
    (tmp_path / "ck" / "checkpoint_2.pt").unlink()

    seen = {}
    import tao_amodal_torch.train.loop as loop

    real = loop.Trainer.load_checkpoint

    def spy(self, step=None):
        out = real(self, step)
        seen["epoch"] = self.epoch
        seen["model"] = {k: v.clone() for k, v in
                         self.state.model.state_dict().items()}
        return out

    loop.Trainer.load_checkpoint = spy
    try:
        resumed = train_main(args + ["--resume"])
    finally:
        loop.Trainer.load_checkpoint = real
    assert seen["epoch"] == 1 and resumed.epoch == 2
    for k, v in saved["state"]["model"].items():
        assert torch.equal(seen["model"][k], v), k

    # PasteNOcclude on the last epoch (resumed from epoch 1).
    (tmp_path / "pno").mkdir()
    (tmp_path / "pno" / "checkpoint_1.pt").write_bytes(
        (tmp_path / "ck" / "checkpoint_1.pt").read_bytes())
    occluded = train_main(["--smoke", "--cpu", "--batch_size", "2",
                           "--paste_n_occlude", "--resume",
                           "--checkpoint_dir", str(tmp_path / "pno")])
    assert occluded.epoch == 2 and 2 in occluded.checkpoints()
    for trainer in (first, resumed, occluded):
        for t in trainer.state.model.parameters():
            assert torch.isfinite(t).all()
