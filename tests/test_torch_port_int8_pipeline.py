"""``AmodalPipeline.create(int8_backbone=True)`` of the port held against
the JAX package's on the CPU, ``streaming`` and ``batched``, at every stem
in f32 (bf16: ``tests/test_torch_port_int8_bf16_pipeline.py``, on this
file's functions), at the CPU tests' small architecture.

Two videos of two coherent clips (a base clip plus small noise per
frame; for ``s2d_pre`` the same clips folded to 48 channels) run through
JAX's int8 pipeline (the reference, jitted with XLA's algebraic
simplifier off: it rewrites the quantizer's ``max / 127.0`` as ``max *
(1 / 127)``, one ulp off for some maxima, such as 9.0, which then flips
every quantized value of that conv near a .5 boundary; op by op, JAX
divides as the port does), the port's int8 pipeline, and the f32 trunk
on the same weights (each ``qkernel`` as the f32 ``Conv_0``; the port's,
which the f32 tests hold to JAX's within f32 rounding): ``streaming``
per video with the SORT state threaded, and ``batched`` over both
videos, whose trunk quantizes the folded ``[2*T]`` frames with one scale
per conv, as JAX's ``batched`` does (so it is not two ``streaming``
calls).

The rule, and why.  ``tests/test_torch_port_int8.py`` shows each conv
exact on equal inputs, and counts what the trunks do on their own: an
f32 BatchNorm output one ulp apart (PyTorch's and XLA's sums) crosses a
quantization step now and then, and one such seed cascades to up to an
eighth of the last stage's quantized values.  So the port's pyramid
sits near JAX's int8 pyramid, far nearer than the f32 trunk's:

* the pyramid (P3-P7 of each video's first clip, and of the folded
  ``[2*T]`` batch): mean |d| to JAX's int8 pyramid at most half the f32
  trunk's, level by level.  A port that computed the f32 trunk, or
  quantized per video in ``batched``, fails it.

At random weights a frame's detection scores lie close together, so a
cascade, like the f32 trunk, reorders detections of near-equal score or
swaps one at the cut to ``num_dets`` (with the classic stem in bf16
even JAX's default jit and its exact-rounding run share only about half
their detections).  So detections are compared as matched pairs (per
frame, greedily by IoU >= 0.9 within a class;
``tests/test_torch_port_bf16_pipeline.py``), and the port's int8 run
must be no further from JAX's than the f32 trunk is:

* unmatched detections (either side's) plus track ids that break a
  one-to-one map, summed over both videos: at most the f32 trunk's;
* on matched pairs, the mean |d| of the visible boxes and of the scores:
  at most half the f32 trunk's.

Every unmatched detection is printed.  The f32 trunk's ``batched``
equals its ``streaming`` (``tests/test_torch_port_batched.py``), so its
``streaming`` run serves both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_bf16_pipeline import agreement, host
from torch_port_fixtures import (
    S,
    T,
    jax_pipeline,
    one_torch_thread,
    save_npz,
    torch_pipeline,
)

STEMS = ("classic", "s2d", "s2d_pre")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# Every bf16 rounding the JAX program states (the bf16 slice's tests),
# and every division it states: XLA's algebraic simplifier turns the
# quantizer's ``max / 127.0`` into ``max * (1 / 127)``, one ulp off for
# some maxima (9.0), and every quantized value of that conv near a .5
# boundary then flips.
AS_WRITTEN = {"xla_allow_excess_precision": False,
              "xla_disable_hlo_passes": "algsimp"}

_one_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


def videos(stem, seed=3, b=2, clips=2):
    """``[b][clips]`` f32 clips ``[T, S, S, 3]`` of coherent videos (the
    ``s2d_pre`` stem's folded ``[T, S/4, S/4, 48]``)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(b):
        base = rs.randn(1, S, S, 3).astype(np.float32)
        vid = [base + 0.01 * rs.randn(T, S, S, 3).astype(np.float32)
               for _ in range(clips)]
        if stem == "s2d_pre":
            vid = [c.reshape(T, S // 4, 4, S // 4, 4, 3).transpose(
                0, 1, 3, 2, 4, 5).reshape(T, S // 4, S // 4, 48)
                for c in vid]
        out.append(vid)
    return out


def as_f32_trunk(variables):
    """The JAX int8 pipeline's variables for its f32 twin: each
    ``qkernel`` as ``Conv_0/kernel`` (the same HWIO array)."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        return {("Conv_0" if k == "qkernel" else k):
                ({"kernel": v} if k == "qkernel" else walk(v))
                for k, v in node.items()}
    return walk(variables)


def make_runs(stem, dt, tmp_path_factory):
    """JAX's int8 runs (``streaming`` per video, ``batched``, pyramids of
    each video's first clip and of their fold), the port's int8 pipeline,
    and the f32 trunk on the same weights (the port's, held to JAX's
    within f32 rounding by ``tests/test_torch_port_pipeline.py`` and
    ``test_torch_port_s2d_pipeline.py``): its ``streaming`` per video
    and the fold's pyramid."""
    jdt, tdt = DTYPES[dt]
    clips = videos(stem)
    first = np.concatenate([vid[0] for vid in clips])    # [2*T, ...]
    pipe, v = jax_pipeline(seed=1, int8_backbone=True, stem=stem, dtype=jdt)
    step = jax.jit(lambda v, c, s: pipe.streaming(v, c, s, score_thr=0.0),
                   compiler_options=AS_WRITTEN)
    both = jax.jit(lambda v, c, s: pipe.batched(v, c, s, score_thr=0.0),
                   compiler_options=AS_WRITTEN)
    feats = jax.jit(lambda v, c: pipe.detector.apply(
        v["detector"], c, method=pipe.detector.features_for),
        compiler_options=AS_WRITTEN)
    jax_run = {"streaming": [], "batched": [[] for _ in clips],
               "pyramids": {"fold": [host(p) for p in feats(
                   v, jnp.asarray(first).astype(jdt))]}}
    for b, vid in enumerate(clips):
        state, per = pipe.init_tracker_state(), []
        for c in vid:
            o, state = step(v, jnp.asarray(c).astype(jdt), state)
            per.append({k: host(x) for k, x in o.items()})
        jax_run["streaming"].append(per)
        jax_run["pyramids"][b] = [host(p) for p in feats(
            v, jnp.asarray(vid[0]).astype(jdt))]
    states = None
    for c in range(len(clips[0])):
        o, states = both(v, jnp.asarray(np.stack(
            [vid[c] for vid in clips])).astype(jdt), states)
        for b in range(len(clips)):
            jax_run["batched"][b].append(
                {k: host(x[b]) for k, x in o.items()})
    tmp = tmp_path_factory.mktemp(f"{stem}{dt}")
    tp = torch_pipeline(save_npz(tmp, v), int8_backbone=True, stem=stem,
                        dtype=tdt)
    f32_trunk = torch_pipeline(save_npz(tmp, as_f32_trunk(v), "f32.npz"),
                               stem=stem, dtype=tdt)
    f32_run = {"streaming": [run_port(f32_trunk, vid, tdt)
                             for vid in clips],
               "pyramids": {"fold": port_pyramid(f32_trunk, first, tdt)}}
    return f"{stem} {dt}", clips, tdt, {"int8": jax_run, "f32": f32_run}, tp


def run_port(tp, vid, tdt):
    """``tp.streaming`` over one video's clips, the state threaded: the
    per-clip host outputs."""
    state, per = tp.init_tracker_state(), []
    for c in vid:
        o, state = tp.streaming(torch.from_numpy(c).to(tdt), state,
                                score_thr=0.0)
        assert o["scores"].dtype == tdt
        per.append({k: host(x) for k, x in o.items()})
    assert int(state.next_id) > 1
    return per


def gaps(x, ref):
    """``x`` against ``ref`` (lists of per-clip host dicts of one video):
    [unmatched detections of either side + track ids off a one-to-one
    map, sum of matched |d| box means, sum of matched score |d|, pairs],
    and the unmatched detections of ``x``."""
    pairs, unmatched, broken = agreement(x, ref)
    n_ref = sum(int(r["valid"].sum()) for r in ref)
    box = sum(float(np.abs(x[c]["visible_boxes"][t, i]
                           - ref[c]["visible_boxes"][t, j]).mean())
              for c, t, i, j in pairs)
    score = sum(abs(float(x[c]["scores"][t, i]) - float(
        ref[c]["scores"][t, j])) for c, t, i, j in pairs)
    return (np.array([len(unmatched) + (n_ref - len(pairs)) + len(broken),
                      box, score, len(pairs)]), unmatched)


def assert_no_further_than_f32(got, ref, f32_run, what):
    """The module docstring's detection rule over the videos."""
    mine, theirs = np.zeros(4), np.zeros(4)
    for v, (g, r, f) in enumerate(zip(got, ref, f32_run)):
        m, unmatched = gaps(g, r)
        mine, theirs = mine + m, theirs + gaps(f, r)[0]
        for c, t, i in unmatched:
            print(f"{what} video {v} clip {c} frame {t} det {i} (class "
                  f"{g[c]['classes'][t, i]}, score {g[c]['scores'][t, i]:.8g})"
                  f" has no JAX counterpart")
    print(f"{what}: port {mine[0]:.0f} unmatched or off-map, {mine[3]:.0f} "
          f"pairs, box |d| {mine[1] / mine[3]:.4f} px, score |d| "
          f"{mine[2] / mine[3]:.3e}; f32 trunk {theirs[0]:.0f}, "
          f"{theirs[3]:.0f} pairs, {theirs[1] / theirs[3]:.4f} px, "
          f"{theirs[2] / theirs[3]:.3e}")
    assert mine[3] > 0 and theirs[3] > 0
    assert mine[0] <= theirs[0], (what, mine[0], theirs[0])
    for k in (1, 2):
        assert mine[k] / mine[3] <= 0.5 * theirs[k] / theirs[3], (
            what, k, mine[k] / mine[3], theirs[k] / theirs[3])


def assert_pyramid_near(got, ref, f32_ref, what):
    """Level by level, mean |d| to JAX's int8 pyramid at most half the
    f32 trunk's."""
    for lvl, (g, r, f) in enumerate(zip(got, ref, f32_ref)):
        d, d32 = np.abs(g - r).mean(), np.abs(f - r).mean()
        print(f"{what} P{lvl + 3}: mean |d| {d:.3e}, f32 trunk {d32:.3e}")
        assert d <= 0.5 * d32, (what, lvl, d, d32)


def port_pyramid(tp, clip, tdt):
    with torch.no_grad():
        return [host(p.permute(0, 2, 3, 1)) for p in
                tp.detector.features_for(torch.from_numpy(clip).to(tdt))]


@pytest.fixture(scope="module", params=STEMS)
def runs(request, tmp_path_factory):
    return make_runs(request.param, "f32", tmp_path_factory)


def test_int8_streaming_matches_jax(runs):
    check_streaming(runs)


def test_int8_batched_matches_jax_batched(runs):
    check_batched(runs)


def check_streaming(runs):
    """``streaming`` over each video's two clips, the state threaded; the
    pyramid of each video's first clip."""
    what, clips, tdt, out, tp = runs
    for b, vid in enumerate(clips):
        assert_pyramid_near(port_pyramid(tp, vid[0], tdt),
                            out["int8"]["pyramids"][b],
                            [p[b * T:(b + 1) * T] for p in
                             out["f32"]["pyramids"]["fold"]],
                            f"{what} video {b}")
    got = [run_port(tp, vid, tdt) for vid in clips]
    assert_no_further_than_f32(got, out["int8"]["streaming"],
                               out["f32"]["streaming"], what + " streaming")


def check_batched(runs):
    """``batched`` over both videos (one scale per conv for the folded
    frames) against JAX's ``batched``; the pyramid of the fold."""
    what, clips, tdt, out, tp = runs
    assert_pyramid_near(
        port_pyramid(tp, np.concatenate([vid[0] for vid in clips]), tdt),
        out["int8"]["pyramids"]["fold"], out["f32"]["pyramids"]["fold"],
        what + " fold")
    states, got = None, [[] for _ in clips]
    for c in range(len(clips[0])):
        o, states = tp.batched(torch.from_numpy(np.stack(
            [vid[c] for vid in clips])).to(tdt), states, score_thr=0.0)
        for b in range(len(clips)):
            got[b].append({k: host(x[b]) for k, x in o.items()})
    assert_no_further_than_f32(got, out["int8"]["batched"],
                               out["f32"]["streaming"], what + " batched")
