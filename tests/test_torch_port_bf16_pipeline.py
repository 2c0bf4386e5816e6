"""The JAX bench's serving configuration -- bf16, the ``s2d_pre`` stem,
4:3 frames -- through the port's pipeline, held against the JAX
package's on the CPU at the CPU tests' small architecture.

uint8 frames of two coherent 60x80 videos (a base image plus small
noise) are letterboxed to (48, 64) by ``preprocess`` and run through
``streaming`` (two clips of 4 frames, the SORT state threaded) and
``batched`` (both videos at once), with ``pooling="fused"`` (B2's
function; JAX's B2 in interpret mode) and ``"packed"`` (JAX's XLA
``prroi_pool``).  The JAX side is jitted with XLA's excess precision
off, so that XLA keeps every bf16 rounding the JAX program states (its
default lets a fusion skip them; on this scene that version and the op
by op one agree in every integer).

Tolerances, and why.  The port and JAX sum each product in f32 in other
orders, so a bf16 result near a rounding boundary lands one ulp apart
now and then, and through 17 random-weight convs such flips spread (the
module tests, ``tests/test_torch_port_bf16_modules.py``, hold each
module on equal inputs to B8's rule).  At random weights the detection
scores of a frame lie within a few bf16 ulps of each other (8 classes at
about 1/8 each), so such a flip can reorder detections of near-equal
score, or swap one for another at the cut to ``num_dets``: slot by slot
two faithful bf16 runs differ, as JAX's own default jit (XLA's excess
precision on: fusions skip bf16 roundings) differs from the reference
run.  So detections are compared as matched pairs (per frame, greedily
by IoU >= 0.9 within a class):

* ``valid`` equal slot by slot;
* unmatched detections and track ids that break a one-to-one map between
  matched pairs, summed over both videos: no more than between JAX's
  default jit and the reference (JAX's own bf16 spread); every one is
  printed, with its score (CHANGES.md lists them);
* floats on matched pairs: boxes' mean |d| at most half the mean gap
  between JAX's own bf16 and f32 runs (matched the same way), so that a
  port computing f32 fails; scores within two bf16 ulps;
* downstream of the trunk the port is held slot by slot: on JAX's own
  bf16 pyramid the port's heads give JAX's classes and scores, and boxes
  within 0.25 px (a one-ulp flip of a bf16 box delta of magnitude <= 0.5
  is 2**-9 of a box side of at most 64 px).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import jax_pipeline, save_npz, torch_pipeline

NO_EXCESS = {"xla_allow_excess_precision": False}
# The same detection moves by well under a pixel; IoU >= 0.9 keeps two
# neighbouring detections of a class from pairing.
MATCH_IOU = 0.9
T, HW, OUT = 4, (60, 80), (48, 64)


def videos(seed, b=2, clips=2):
    """uint8 ``[b, clips * T, 60, 80, 3]``: a base image per video plus
    small noise per frame."""
    rs = np.random.RandomState(seed)
    base = rs.randint(0, 256, (b, 1, *HW, 3))
    noise = rs.randint(-3, 4, (b, clips * T, *HW, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def host(v):
    if torch.is_tensor(v):
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(jnp.asarray(v, jnp.float32)
                      if v.dtype == jnp.bfloat16 else v)


def interpret_b2(mp):
    """Run JAX's B2 in interpret mode, as tests/test_torch_port_roi.py
    does."""
    import tao_amodal_tpu.ops.pallas.prroi as P

    orig = P.prroi_packed_fused
    mp.setattr(P, "prroi_packed_fused",
               lambda f, r, out_size=7, wmaj=True, interpret=False,
               pre_transposed=False: orig(f, r, out_size=out_size,
                                          wmaj=wmaj, interpret=True,
                                          pre_transposed=pre_transposed))


@pytest.fixture(scope="module", params=["fused", "packed"])
def slice_run(request, tmp_path_factory):
    """One pooling route: JAX's bf16 reference run (excess precision
    off), its default jit, and its f32 run, streaming each video's two
    clips; and the port's bf16 pipeline on the same weights."""
    pooling = request.param
    mp = pytest.MonkeyPatch()
    interpret_b2(mp)
    frames = videos(seed=21)
    runs = {}
    for name, jdt, opts in (("bf16", jnp.bfloat16, NO_EXCESS),
                            ("bf16_default_jit", jnp.bfloat16, None),
                            ("f32", jnp.float32, NO_EXCESS)):
        pipe, variables = jax_pipeline(seed=6, dtype=jdt, stem="s2d_pre",
                                       pooling=pooling)
        step = jax.jit(lambda v, c, s, p=pipe: p.streaming(
            v, c, s, score_thr=0.0), compiler_options=opts)
        outs = []
        for vid in range(frames.shape[0]):
            state, per = pipe.init_tracker_state(), []
            for c in range(2):
                clip, _ = pipe.preprocess(
                    jnp.asarray(frames[vid, c * T:(c + 1) * T]),
                    out_size=OUT)
                out, state = step(variables, clip, state)
                per.append({k: host(v) for k, v in out.items()})
            outs.append(per)
        runs[name] = (pipe, variables, outs)
    mp.undo()
    npz = save_npz(tmp_path_factory.mktemp(pooling), runs["bf16"][1])
    tp = torch_pipeline(npz, dtype=torch.bfloat16, stem="s2d_pre",
                        pooling=pooling)
    return pooling, frames, runs, tp


def iou(a, b):
    x0, y0 = np.maximum(a[0], b[0]), np.maximum(a[1], b[1])
    x1, y1 = np.minimum(a[2], b[2]), np.minimum(a[3], b[3])
    inter = max(x1 - x0, 0) * max(y1 - y0, 0)
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / union if union > 0 else 0.0


def agreement(x, y):
    """Runs ``x`` and ``y`` (lists of per-clip host output dicts) matched
    per frame, greedily by IoU >= MATCH_IOU within a class: (matched pairs as
    (clip, frame, i, j), unmatched detections of ``x`` as (clip, frame,
    i), matched pairs whose track ids break a one-to-one map)."""
    pairs, unmatched = [], []
    for c, (a, b) in enumerate(zip(x, y)):
        for t in range(a["valid"].shape[0]):
            cand = sorted(((iou(a["visible_boxes"][t, i],
                                b["visible_boxes"][t, j]), i, j)
                           for i in np.nonzero(a["valid"][t])[0]
                           for j in np.nonzero(b["valid"][t])[0]
                           if a["classes"][t, i] == b["classes"][t, j]),
                          reverse=True)
            used_i, used_j = set(), set()
            for v, i, j in cand:
                if v >= MATCH_IOU and i not in used_i and j not in used_j:
                    used_i.add(i)
                    used_j.add(j)
                    pairs.append((c, t, i, j))
            unmatched += [(c, t, i) for i in np.nonzero(a["valid"][t])[0]
                          if i not in used_i]
    fwd, bwd, broken = {}, {}, []
    for c, t, i, j in pairs:
        ix, iy = x[c]["track_ids"][t, i], y[c]["track_ids"][t, j]
        if fwd.setdefault(ix, iy) != iy or bwd.setdefault(iy, ix) != ix:
            broken.append((c, t, i, j))
    return pairs, unmatched, broken


def box_gap(x, y, pairs):
    """(sum of mean |d| of matched visible boxes, number of pairs)."""
    return (sum(float(np.abs(x[c]["visible_boxes"][t, i]
                             - y[c]["visible_boxes"][t, j]).mean())
                for c, t, i, j in pairs), len(pairs))


def compare(got, ref, default_jit, f32_run, what):
    """The port's clips ``got`` of one video against JAX's reference
    clips ``ref`` by the module docstring's rules.  Returns, for the
    caller to sum over videos, the counts of (unmatched, off-map)
    detections of the port and of JAX's default jit, and the box gaps
    (sum, pairs) of the port and of JAX's f32 run."""
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["valid"], r["valid"],
                                      err_msg=what + " valid")
    pairs, unmatched, broken = agreement(got, ref)
    _, own_unmatched, own_broken = agreement(default_jit, ref)
    for c, t, i in unmatched:
        mine = got[c]["classes"][t, i], got[c]["scores"][t, i]
        theirs = ref[c]["classes"][t, i], ref[c]["scores"][t, i]
        print(f"{what}: clip {c} frame {t} det {i} (class {mine[0]}, score "
              f"{mine[1]:.8g}) has no JAX counterpart; JAX's det {i}: class "
              f"{theirs[0]}, score {theirs[1]:.8g}")
    for c, t, i, j in broken:
        ids = got[c]["track_ids"][t, i], ref[c]["track_ids"][t, j]
        scores = got[c]["scores"][t, i], ref[c]["scores"][t, j]
        print(f"{what}: clip {c} frame {t} det {i}: track {ids[0]} against "
              f"JAX's {ids[1]} (scores {scores[0]:.8g}, {scores[1]:.8g})")
    print(f"{what}: {len(pairs)} matched, {len(unmatched)} unmatched, "
          f"{len(broken)} track ids off the map; JAX's default jit: "
          f"{len(own_unmatched)} unmatched, {len(own_broken)} off the map")
    f_pairs, _, _ = agreement(f32_run, ref)
    for c, t, i, j in pairs:
        s, w = got[c]["scores"][t, i], ref[c]["scores"][t, j]
        assert abs(s - w) <= 2.0 ** (np.floor(np.log2(w)) - 6), (
            what, c, t, s, w)
    return np.array([len(unmatched), len(broken), len(own_unmatched),
                     len(own_broken), *box_gap(got, ref, pairs),
                     *box_gap(f32_run, ref, f_pairs)])


def assert_within_jax_spread(totals, what):
    """Over the videos: the port's unmatched and off-map detections at
    most JAX's default jit's, and the port's mean box gap on matched
    pairs at most half JAX's bf16-vs-f32 one."""
    mine, jax_own = totals[:2], totals[2:4]
    assert (mine <= jax_own).all(), (what, mine.tolist(), jax_own.tolist())
    gap, f32_gap = totals[4] / totals[5], totals[6] / totals[7]
    print(f"{what}: matched boxes mean |d| {gap:.4f} px; JAX bf16 vs f32 "
          f"{f32_gap:.4f} px")
    assert gap <= 0.5 * f32_gap, (what, gap, f32_gap)


def check_dtypes(out):
    """The port's output dtypes are JAX's (bf16 scores, f32 boxes)."""
    assert out["scores"].dtype == torch.bfloat16
    assert out["boxes"].dtype == out["visible_boxes"].dtype == torch.float32
    assert not out["classes"].dtype.is_floating_point


def test_bf16_s2d_pre_streaming_matches_jax(slice_run):
    """``create(dtype=bf16, stem="s2d_pre")``: ``preprocess`` then
    ``streaming`` over two clips of each video, state threaded."""
    pooling, frames, runs, tp = slice_run
    counts = 0
    for v in range(frames.shape[0]):
        state, got = tp.init_tracker_state(), []
        for c in range(2):
            clip, _ = tp.preprocess(
                torch.from_numpy(frames[v, c * T:(c + 1) * T]),
                out_size=OUT)
            assert clip.dtype == torch.bfloat16
            assert clip.shape == (T, 12, 16, 48)
            out, state = tp.streaming(clip, state, score_thr=0.0)
            check_dtypes(out)
            got.append({k: host(x) for k, x in out.items()})
        assert int(state.next_id) > 1
        counts = counts + compare(
            got, runs["bf16"][2][v], runs["bf16_default_jit"][2][v],
            runs["f32"][2][v], f"{pooling} video {v}")
    assert_within_jax_spread(counts, pooling)


def test_bf16_s2d_pre_batched_matches_jax(slice_run):
    """``batched`` over both videos' clips, states threaded, against
    JAX's ``streaming`` per video (JAX's ``batched`` equals it,
    ``tests/test_batched_pipeline.py``)."""
    pooling, frames, runs, tp = slice_run
    states, got = None, [[], []]
    for c in range(2):
        clips = torch.stack([tp.preprocess(torch.from_numpy(
            frames[v, c * T:(c + 1) * T]), out_size=OUT)[0]
            for v in range(frames.shape[0])])
        out, states = tp.batched(clips, states, score_thr=0.0)
        check_dtypes(out)
        for v in range(frames.shape[0]):
            got[v].append({k: host(x[v]) for k, x in out.items()})
    counts = sum(compare(got[v], runs["bf16"][2][v],
                         runs["bf16_default_jit"][2][v], runs["f32"][2][v],
                         f"{pooling} batched video {v}")
                 for v in range(frames.shape[0]))
    assert_within_jax_spread(counts, pooling + " batched")


def test_bf16_heads_on_jax_pyramid_match_exactly(slice_run, monkeypatch):
    """The port's proposals, pooling, box head and NMS
    (``ClipDetector.detect``) on JAX's own bf16 pyramid against JAX's
    ``_frame_detect``: JAX's output dtypes (f32 boxes decoded from bf16
    deltas against f32 proposals, bf16 scores and RoI features), classes
    and valid slots equal, scores equal to a bf16 ulp, boxes within
    0.25 px (module docstring)."""
    pooling, frames, runs, tp = slice_run
    interpret_b2(monkeypatch)
    pipe, variables, _ = runs["bf16"]
    clip, _ = pipe.preprocess(jnp.asarray(frames[0, :T]), out_size=OUT)
    det = pipe.detector
    image_hw = det.image_hw_of(clip)
    pyramid = det.apply(variables["detector"], clip,
                        method=lambda m, c: m.features_for(c))
    want = det.apply(variables["detector"], pyramid, method=lambda m, p: (
        jax.vmap(lambda fp: m._frame_detect(fp, image_hw))(p)))
    with torch.no_grad():
        got = tp.detector.detect(
            [torch.from_numpy(host(p)).to(torch.bfloat16).permute(0, 3, 1, 2)
             for p in pyramid], image_hw)
    for k in ("boxes", "scores", "roi_features"):  # JAX's output dtypes
        assert got[k].dtype == {jnp.float32: torch.float32,
                                jnp.bfloat16: torch.bfloat16}[
            want[k].dtype.type], (k, got[k].dtype, want[k].dtype)
    np.testing.assert_array_equal(host(got["classes"]), host(want["classes"]))
    valid = host(want["classes"]) >= 0
    assert valid.any()
    s = host(want["scores"])
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(s, 1e-30))) - 7)
    assert (np.abs(host(got["scores"]) - s) <= ulp).all()
    np.testing.assert_allclose(host(got["boxes"]), host(want["boxes"]),
                               atol=0.25)
