"""The port's one-program-per-clip serving (``make_inference_fn``,
``make_streaming_fn``, ``make_batched_fn``, ``utils/graphs.py``) and the
NMS and greedy fixpoints (``csrc/fixpoint.cu`` and their plain
versions).

On the CPU: ``make_inference_fn`` against JAX's ``make_inference_fn``
(boxes rtol 1e-4 + atol 1e-3 px and scores atol 1e-5: f32 through the
trunk in another summation order; integers exact on a coherent scene);
the captured functions on a CPU pipeline equal the eager ones exactly
(they run eagerly); the plain fixpoints against JAX's ``nms_keep_mask``
and ``greedy_assign`` exactly, on seeded scenes and on chains deeper
than the 8 and 6 rounds JAX unrolls.  Tests marked ``cuda`` (captured
against eager, no host sync in a replay, the kernels against their plain
versions bit for bit, a failed capture raising) skip without a card.

jax is imported inside the tests that hold the port to the JAX package
(they skip where jax or flax is missing), so that on the card's machine,
which has no flax, the ``cuda`` tests run with ``python -m pytest
--noconftest tests/test_torch_port_captured.py``.
"""

import numpy as np
import pytest
import torch

from torch_port_fixtures import (
    S,
    T,
    TINY,
    greedy_fixpoint,
    one_torch_thread,
)

NEG = -1e9

module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def coherent_clips(seed, n=3, t=T, s=S):
    """n clips of one slowly changing scene (base frame plus small
    noise): detections persist and SORT keeps its tracks across frames
    and clips, away from f32 near-ties."""
    rs = np.random.RandomState(seed)
    base = rs.randn(1, s, s, 3).astype(np.float32)
    return [base + 0.01 * rs.randn(t, s, s, 3).astype(np.float32)
            for _ in range(n)]


def small_pipeline(device, **kw):
    from tao_amodal_torch.pipeline import AmodalPipeline

    return AmodalPipeline.create(**{**TINY, **kw}, device=device).init(
        torch.Generator(device=device).manual_seed(0))


def assert_outputs_equal(got, want, exact=True):
    assert set(got) == set(want)
    for k in ("classes", "track_ids", "valid"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-4, atol=1e-3)
    for k in ("boxes", "visible_boxes", "scores"):
        torch.testing.assert_close(got[k], want[k], **tol, msg=k)


# ---------------------------------------------------------------- CPU


def test_make_inference_fn_matches_jax(tmp_path):
    """One clip with a fresh tracker at the default score threshold,
    the port's ``make_inference_fn(pipeline)`` against JAX's
    ``make_inference_fn(pipeline, variables)`` (a jitted program)."""
    pytest.importorskip("jax")
    pytest.importorskip("flax")  # the JAX pipeline's modules
    import jax.numpy as jnp

    from tao_amodal_tpu.pipeline import make_inference_fn as jax_make
    from tao_amodal_torch.pipeline import make_inference_fn
    from torch_port_fixtures import jax_pipeline, save_npz, torch_pipeline

    pipe, variables = jax_pipeline(seed=5)
    tp = torch_pipeline(save_npz(tmp_path, variables))
    jrun, trun = jax_make(pipe, variables), make_inference_fn(tp)
    for clip in coherent_clips(6, n=2):
        want = jrun(jnp.asarray(clip))
        got = trun(torch.from_numpy(clip))
        assert set(got) == set(want)
        for k in ("classes", "track_ids", "valid"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        for k in ("boxes", "visible_boxes"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-3, err_msg=k)
        np.testing.assert_allclose(got["scores"].numpy(),
                                   np.asarray(want["scores"]), atol=1e-5)
        # The default threshold keeps detections, and tracks are born.
        assert got["valid"].any() and got["track_ids"].max() > 0
    assert trun.captured.graphs == {}  # a CPU pipeline runs eagerly


@pytest.mark.parametrize("assignment", ["greedy", "gated_auction"])
def test_captured_functions_on_cpu_equal_eager(assignment):
    """On a CPU pipeline ``make_streaming_fn`` and ``make_batched_fn``
    run the eager functions: equal outputs and states, bit for bit, over
    three threaded clips; no graph is built."""
    from tao_amodal_torch.pipeline import make_batched_fn, make_streaming_fn

    pipe = small_pipeline("cpu", sort_assignment=assignment)
    clips = [torch.from_numpy(c) for c in coherent_clips(2)]
    run = make_streaming_fn(pipe, score_thr=0.0)
    se = sc = pipe.init_tracker_state()
    for clip in clips:
        want, se = pipe.streaming(clip, se, score_thr=0.0)
        got, sc = run(clip, sc)
        assert_outputs_equal(got, want)
    for f, g in zip(sc, se):
        torch.testing.assert_close(f, g, rtol=0, atol=0)
    assert int(sc.next_id) > 1 and run.captured.graphs == {}
    batch = torch.stack(clips[:2])
    want, ws = pipe.batched(batch, score_thr=0.0)
    got, gs = make_batched_fn(pipe, score_thr=0.0)(batch)
    assert_outputs_equal(got, want)
    for f, g in zip(gs, ws):
        torch.testing.assert_close(f, g, rtol=0, atol=0)


def overlap_chain(n, step=10.0, width=20.0):
    """n boxes in a row, each overlapping the next at IoU 1/3 and the one
    after not at all, scores falling along the row: greedy NMS at 0.3
    keeps every other box, and the fixpoint needs about n rounds."""
    x = np.arange(n, dtype=np.float32) * step
    boxes = np.stack([x, np.zeros_like(x), x + width,
                      np.full_like(x, 10.0)], -1)
    return boxes, np.linspace(0.9, 0.1, n).astype(np.float32)


def nms_scenes(seed):
    """Seeded clustered scenes (boxes around a few centres, tied scores,
    invalid entries), and chains of 20 and 45 boxes (beyond JAX's 8
    unrolled rounds)."""
    rs = np.random.RandomState(seed)
    for n in (12, 40, 96):
        centre = rs.uniform(20, 200, (4, 2))[rs.randint(0, 4, n)]
        xy = centre + rs.randn(n, 2) * 8
        wh = rs.uniform(20, 60, (n, 2))
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        scores = np.round(rs.rand(n), 1).astype(np.float32)  # ties
        yield boxes, scores, rs.rand(n) > 0.15
    for n in (20, 45):
        boxes, scores = overlap_chain(n)
        yield boxes, scores, np.ones(n, bool)


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_fixpoint_matches_jax(seed):
    """The port's ``nms_keep_mask`` (its rounds in the plain
    ``nms_fixpoint_torch``) against JAX's ``nms_keep_mask`` (unrolled
    rounds and a ``while_loop``): equal keep masks, per scene and with
    the scenes of one size stacked on a leading axis."""
    pytest.importorskip("jax")
    pytest.importorskip("flax")
    import jax.numpy as jnp

    from tao_amodal_tpu.ops.nms import nms_keep_mask as jax_keep
    from tao_amodal_torch.ops import nms

    chain_rounds = []
    for boxes, scores, valid in nms_scenes(seed):
        want = np.asarray(jax_keep(jnp.asarray(boxes), jnp.asarray(scores),
                                   0.3, valid=jnp.asarray(valid)))
        got = nms.nms_keep_mask(torch.from_numpy(boxes),
                                torch.from_numpy(scores), 0.3,
                                valid=torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy(), want)
        batched = nms.nms_keep_mask(
            torch.from_numpy(np.stack([boxes, boxes[::-1].copy()])),
            torch.from_numpy(np.stack([scores, scores])), 0.3,
            valid=torch.from_numpy(np.stack([valid, valid])))
        np.testing.assert_array_equal(batched[0].numpy(), want)
        if valid.all() and len(boxes) in (20, 45):
            np.testing.assert_array_equal(want, np.arange(len(boxes)) % 2
                                          == 0)
            chain_rounds.append(len(boxes))
    assert chain_rounds == [20, 45]


def test_nms_fixpoint_plain_counts_no_launch():
    """``nms_fixpoint`` on CPU tensors takes the plain version (no
    launch counted) and keeps nothing that is invalid."""
    from tao_amodal_torch.ops import nms

    boxes, scores = overlap_chain(30)
    before = nms.nms_fixpoint.launches
    keep = nms.nms_keep_mask(torch.from_numpy(boxes),
                             torch.from_numpy(scores), 0.3,
                             valid=torch.arange(30) != 4)
    assert nms.nms_fixpoint.launches == before
    assert not keep[4] and keep[5] and keep[0]


def greedy_scenes(seed):
    """Seeded IoU-like benefits with forbidden (NEG) entries, ties, NaN
    and -inf (both masked to NEG before the rounds), and a chain
    ``1 - (i + j) / 1000`` that matches one pair a round (20 rounds,
    beyond JAX's 6 unrolled)."""
    rs = np.random.RandomState(seed)
    for n, m in ((16, 32), (12, 7), (5, 40)):
        b = rs.rand(n, m).astype(np.float32)
        b[rs.rand(n, m) < 0.4] = NEG
        b[0, :3] = b[1, :3] = 0.5  # ties across rows and columns
        b[2, 4] = np.nan
        b[3, 5] = -np.inf
        yield b
    i, j = np.meshgrid(np.arange(20), np.arange(30), indexing="ij")
    yield (1 - (i + j) * 1e-3).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_fixpoint_matches_jax(seed):
    """The port's ``greedy_assign`` (its rounds in the plain
    ``greedy_fixpoint_torch``) against JAX's ``greedy_assign`` and the
    numpy fixpoint of the fixtures: equal assignments; the chain takes
    20 rounds.  The masked benefit holds no NaN (what the kernel is
    given)."""
    pytest.importorskip("jax")
    pytest.importorskip("flax")
    import jax.numpy as jnp

    from tao_amodal_tpu.ops.hungarian import greedy_assign as jax_greedy
    from tao_amodal_torch.ops import hungarian

    rounds = []
    for b in greedy_scenes(seed):
        want = np.asarray(jax_greedy(jnp.asarray(b)))
        got = hungarian.greedy_assign(torch.from_numpy(b))
        np.testing.assert_array_equal(got.numpy(), want)
        host, r = greedy_fixpoint(b)
        np.testing.assert_array_equal(host, want)
        rounds.append(r)
        masked = torch.where(torch.from_numpy(b) > NEG / 2,
                             torch.from_numpy(b), NEG)
        assert not masked.isnan().any()
    assert rounds[-1] == 20


# --------------------------------------------------------------- CUDA


@pytest.mark.cuda
def test_captured_matches_eager_on_cuda(cuda):
    """``make_streaming_fn`` on the card against eager ``streaming`` over
    three threaded clips, with a second geometry (S = 96) alongside:
    integers equal and floats bit-equal (the replay launches the eager
    path's kernels on the same inputs); one graph per geometry; no host
    sync in a replay."""
    from tao_amodal_torch.pipeline import make_streaming_fn

    pipe = small_pipeline(cuda)
    run = make_streaming_fn(pipe, score_thr=0.0)
    for s in (S, 96):
        clips = [torch.from_numpy(c).to(cuda)
                 for c in coherent_clips(3, s=s)]
        se = sc = pipe.init_tracker_state()
        for clip in clips:
            want, se = pipe.streaming(clip, se, score_thr=0.0)
            got, sc = run(clip, sc)
            assert_outputs_equal(got, want)
        for f, g in zip(sc, se):
            torch.testing.assert_close(f, g, rtol=0, atol=0)
        assert int(sc.next_id) > 1
    assert len(run.captured.graphs) == 2
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = run(clips[0], pipe.init_tracker_state())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out["valid"].any()


@pytest.mark.cuda
def test_captured_batched_and_auction_match_eager_on_cuda(cuda):
    """``make_batched_fn`` (two videos) and ``make_streaming_fn`` with the
    gated auction (the detector captured, the auction eager after the
    replay) against their eager functions."""
    from tao_amodal_torch.pipeline import make_batched_fn, make_streaming_fn

    pipe = small_pipeline(cuda)
    clips = [torch.from_numpy(c).to(cuda) for c in coherent_clips(4)]
    run = make_batched_fn(pipe, score_thr=0.0)
    ws = gs = None
    for batch in (torch.stack(clips[:2]), torch.stack(clips[2:])):
        want, ws = pipe.batched(batch, ws, score_thr=0.0)
        got, gs = run(batch, gs)
        assert_outputs_equal(got, want)
    pipe.sort_assignment = "gated_auction"
    run = make_streaming_fn(pipe, score_thr=0.0)
    se = sc = pipe.init_tracker_state()
    for clip in clips:
        want, se = pipe.streaming(clip, se, score_thr=0.0)
        got, sc = run(clip, sc)
        assert_outputs_equal(got, want)


@pytest.mark.cuda
def test_fixpoint_kernels_match_plain_on_cuda(cuda):
    """``tao_nms_fixpoint`` and ``tao_greedy_fixpoint`` against their
    plain versions, bit for bit: the seeded scenes, chains of N rounds at
    the serving shapes (the RPN's [8, 500, 500], the detector's
    [8, 96, 96], SORT's [64, 128]), and a size past the kernels' shared
    memory (sup read from device memory, b in a workspace)."""
    from tao_amodal_torch.ops import hungarian, nms

    before = (nms.nms_fixpoint.launches, hungarian.greedy_fixpoint.launches)
    for boxes, scores, valid in nms_scenes(0):
        args = (torch.from_numpy(boxes).to(cuda),
                torch.from_numpy(scores).to(cuda), 0.3)
        got = nms.nms_keep_mask(*args, valid=torch.from_numpy(valid).to(cuda))
        want = nms.nms_keep_mask(*(a.cpu() if torch.is_tensor(a) else a
                                   for a in args),
                                 valid=torch.from_numpy(valid))
        assert torch.equal(got.cpu(), want)
    for B, n in ((8, 500), (8, 96), (2, 1500), (3, 1)):
        chain = torch.zeros((B, n, n), dtype=torch.bool, device=cuda)
        idx = torch.arange(n - 1, device=cuda)
        chain[:, idx, idx + 1] = True
        valid = torch.rand((B, n), device=cuda) > 0.05
        assert torch.equal(nms.nms_fixpoint(chain, valid),
                           nms.nms_fixpoint_torch(chain, valid))
    for b in list(greedy_scenes(0)) + [
            np.random.RandomState(1).rand(400, 500).astype(np.float32)]:
        masked = torch.where(torch.from_numpy(b) > NEG / 2,
                             torch.from_numpy(b), NEG).to(cuda)
        assert torch.equal(hungarian.greedy_fixpoint(masked),
                           hungarian.greedy_fixpoint_torch(masked))
    i, j = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    chain_b = torch.from_numpy((1 - (i + j) * 1e-3).astype(np.float32))
    assert torch.equal(hungarian.greedy_fixpoint(chain_b.to(cuda)).cpu(),
                       hungarian.greedy_fixpoint_torch(chain_b))
    assert nms.nms_fixpoint.launches > before[0]
    assert hungarian.greedy_fixpoint.launches > before[1]


@pytest.mark.cuda
def test_failed_capture_raises_on_cuda(cuda):
    """A function that syncs with the host cannot be captured: the
    capture raises and nothing runs eagerly in its place."""
    from tao_amodal_torch.utils import graphs

    def syncs(x):
        return x * float(x.sum())

    with pytest.raises(Exception):
        graphs.capture(syncs)(torch.ones(4, device=cuda))
