"""Shared set-up for the PyTorch port's parity tests.

The small architecture of every ``test_torch_port_*`` file, the JAX
variables it is held against (a real ``AmodalPipeline.init``, then every
BatchNorm statistic, bias and the zero-initialised expander ``deltas``
layer perturbed with seeded numpy noise, so that no bridged tensor is a
trivial identity), the bridge through ``save_pytree`` -> npz ->
``tao_amodal_torch.utils.weights``, and seeded numpy inputs (clips,
frame files, coherent SORT scenes, bottleneck chains), and the greedy
rounds of SORT's association counted on the host.

jax is imported inside the functions that need it, so that the
jax-free ``test_torch_port_isolation.py`` and ``chip_smoke.py`` can
use the numpy helpers on a machine without jax.
"""

import numpy as np

TINY = dict(num_classes=8, num_dets=8, num_proposals=16,
            backbone_stages=(1, 1, 1, 1))
T, S = 4, 64
# Preprocessing geometries (T, H, W, S) off the serving shape: portrait
# frames (pad columns), a width not a multiple of 4 in and out
# (unaligned rows, scalar stores), one frame, S = 320 and 640, an 8K
# frame (a block's rows take more than 48 KB of shared memory) and more
# frames than a grid's 65,535 rows (blocks take several frames).
PREPROC_ODD = ((2, 640, 480, 512), (3, 45, 61, 64), (1, 33, 50, 61),
               (1, 480, 640, 512), (2, 480, 640, 320), (2, 480, 640, 640),
               (2, 500, 375, 640), (1, 4320, 7680, 1024), (65537, 6, 8, 8))


def perturb(tree, rng):
    """Seeded noise on every leaf that Flax initialises to a constant."""
    import jax

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1]
        if name == "mean":
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.randn(*x.shape)).astype(np.float32)
        if name == "bias":
            return (x + 0.05 * rng.randn(*x.shape)).astype(np.float32)
        if path[-2:] == ("deltas", "kernel"):
            return (0.02 * rng.randn(*x.shape)).astype(np.float32)
        return x

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return leaf(path, node)

    return walk(jax.tree_util.tree_map(np.asarray, tree), ())


def jax_pipeline(seed=0, **overrides):
    """(JAX AmodalPipeline, perturbed variables as numpy), initialised on
    a zero clip of the stem's layout (``s2d_pre``: 48 folded channels)."""
    import jax
    import jax.numpy as jnp

    from tao_amodal_tpu.pipeline import AmodalPipeline

    pipe = AmodalPipeline.create(**{**TINY, **overrides})
    shape = ((T, S // 4, S // 4, 48) if pipe.detector.stem == "s2d_pre"
             else (T, S, S, 3))
    variables = jax.jit(pipe.init)(jax.random.PRNGKey(seed),
                                   jnp.zeros(shape))
    return pipe, perturb(variables, np.random.RandomState(seed + 100))


def save_npz(tmp_path, variables, name="pipeline.npz"):
    from tao_amodal_tpu.utils.checkpoint import save_pytree

    path = str(tmp_path / name)
    save_pytree(path, variables)
    return path


def torch_pipeline(npz_path, **overrides):
    from tao_amodal_torch.pipeline import AmodalPipeline

    return AmodalPipeline.create(**{**TINY, **overrides},
                                 device="cpu").load(npz_path)


def random_clip(seed, t=T, s=S):
    """A normalized-looking f32 NHWC clip."""
    return np.random.RandomState(seed).randn(t, s, s, 3).astype(
        np.float32)


def write_frames(images_dir, gt, video_id, seed):
    """PNG frames of one slowly changing scene for ``video_id``'s
    images of the annotation ``gt``."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    base = rs.randint(0, 255, (60, 80, 3))
    for im in gt["images"]:
        if im["video_id"] != video_id:
            continue
        path = images_dir / im["file_name"]
        path.parent.mkdir(parents=True, exist_ok=True)
        frame = np.clip(base + rs.randint(-3, 4, base.shape), 0, 255)
        Image.fromarray(frame.astype(np.uint8)).save(path, format="PNG")


def coherent_scene(seed, frames=30, objects=6, D=16, extent=300):
    """Boxes moving at constant velocity with small jitter; objects
    enter late and leave early (births and deaths), detections are
    missed now and then, and the detection order is shuffled.  Returns
    ``boxes [frames, D, 4]`` f32 and ``valid [frames, D]`` bool."""
    rs = np.random.RandomState(seed)
    start = rs.uniform(20, extent, (objects, 2))
    size = rs.uniform(30, 80, (objects, 2))
    vel = rs.uniform(-4, 4, (objects, 2))
    born = rs.randint(0, frames // 3, objects)
    dies = rs.randint(2 * frames // 3, frames + 1, objects)
    boxes = np.zeros((frames, D, 4), np.float32)
    valid = np.zeros((frames, D), bool)
    for t in range(frames):
        live = [o for o in range(objects)
                if born[o] <= t < dies[o] and rs.rand() > 0.1]
        for d, o in enumerate(rs.permutation(live)):
            xy = start[o] + vel[o] * t + rs.randn(2)
            boxes[t, d] = [*xy, *(xy + size[o] + rs.randn(2))]
            valid[t, d] = True
    return boxes, valid


def chain_inputs(device, shape, M, blocks, projection, seed=0):
    """NHWC input ``shape`` (ReLU'd N(0, 1)) and folded OIHW block params
    of a stride-1 bottleneck chain of width ``M`` (LeCun-scaled weights,
    biases 0.1 N(0, 1)), as ``ResNet`` folds them, on ``device``."""
    import torch

    rs = np.random.RandomState(seed)

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    params, cin = [], shape[-1]
    for b in range(blocks):
        p = dict(wa=(M, cin, 1), w3=(M, M, 3), wb=(4 * M, M, 1))
        if b == 0 and projection:
            p["wd"] = (4 * M, cin, 1)
        block = {}
        for w, (cout, c, k) in p.items():
            block[w] = put(rs.randn(cout, c, k, k) * (c * k * k) ** -0.5)
            block["b" + w[1:]] = put(0.1 * rs.randn(cout))
        params.append(block)
        cin = 4 * M
    return put(np.maximum(rs.randn(*shape), 0)), params


def stack_arrays(shape, M, N, kind, seed=0):
    """Seeded numpy input ``x`` and params (JAX field order) of an
    identity-bottleneck stack, drawn as ``tests/test_resnet_blocks.py``
    draws them: ``kind="int8"`` (``_random_params``: int8 weights, small
    requant scales) or ``"bf16"`` (``_random_bf16_params``, values in f32
    for each side to round to bf16, but with LeCun-scaled weights
    ``N(0, 1/fan_in)`` as the trunk's init draws them: the fixed 0.05 of
    the JAX test gives every conv a gain above 1 at ResNet-50's widths,
    so that a one-ulp bf16 flip grows block after block)."""
    rs = np.random.RandomState(seed)
    C = shape[-1]
    dims = [(N, C, M), (N, M), (N, M), (N, 3, 3, M, M), (N, M), (N, M),
            (N, M, C), (N, C), (N, C)]
    if kind == "int8":
        x = rs.randint(0, 128, shape).astype(np.int8)
        params = []
        for i, d in enumerate(dims):
            if i % 3 == 0:
                params.append(rs.randint(-127, 128, d).astype(np.int8))
            else:
                lo, hi = (1e-4, 3e-4) if i % 3 == 1 else (-.2, .2)
                params.append(rs.uniform(lo, hi, d).astype(np.float32))
        params.append(rs.uniform(0.5, 1.5, (N,)).astype(np.float32))
        return x, params
    x = rs.rand(*shape).astype(np.float32)
    params = []
    for i, d in enumerate(dims):
        if i % 3 == 0:
            a = rs.randn(*d) * float(np.prod(d[1:-1])) ** -0.5
        else:
            a = rs.uniform(0.5, 1.5, d)
        params.append((a - (i % 3 == 2)).astype(np.float32))
    return x, params


def torch_stack(device, x, params, kind):
    """The port's ``(x, QuantBlockParams | Bf16BlockParams)`` on
    ``device`` from :func:`stack_arrays` output."""
    import torch

    from tao_amodal_torch.ops import resnet_blocks

    def put(a, bf16):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t.to(torch.bfloat16) if bf16 else t

    if kind == "int8":
        return put(x, False), resnet_blocks.QuantBlockParams(
            *(put(a, False) for a in params))
    return put(x, True), resnet_blocks.Bf16BlockParams(
        *(put(a, i % 3 == 0) for i, a in enumerate(params)))


def perturb_module(module, rs):
    """Seeded numpy noise on every tensor the port's random init leaves
    constant (BatchNorm statistics and affines, biases, zero-initialised
    layers), so that folding and bridging tests do not pass on
    identities."""
    import torch

    def noise(t, scale, base=0.0):
        t.copy_(torch.from_numpy(base + scale * rs.randn(*t.shape)).to(t))

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                noise(m.running_mean, 0.1)
                m.running_var.copy_(torch.from_numpy(
                    rs.uniform(0.5, 1.5, m.running_var.shape)).to(
                        m.running_var))
                noise(m.weight, 0.1, 1.0)
                noise(m.bias, 0.05)
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                if getattr(m, "zero_init", False):
                    noise(m.weight, 0.02)
                if m.bias is not None:
                    noise(m.bias, 0.05)
    return module


def stage_stacks(resnet, images):
    """Run the unfused f32 trunk ``resnet`` (eval mode) on NCHW
    ``images`` once and return, for each stage with identity blocks, a
    dict: ``stage`` (1-indexed), ``x`` its block-0 output and ``ref`` its
    output (both NHWC f32), ``block_vars`` of its identity blocks, and
    ``act_scales`` calibrated as abs-max / 127 of each tensor of the f32
    run, 'in' of block i being 'out' of block i-1
    (``tests/test_resnet_blocks.py:85-105``)."""
    import torch

    from tao_amodal_torch.utils.weights import block_vars_from_resnet

    amax, kept, handles, first = {}, {}, [], 0

    def hook(key, keep=False):
        def fn(module, inputs, out):
            amax[key] = float(out.abs().max()) / 127.0
            if keep:
                kept[key] = out.permute(0, 2, 3, 1).contiguous()
        return fn

    stages = []
    for s, n in enumerate(resnet.stage_sizes, 1):
        if n >= 2:
            stages.append((s, first, first + n - 1))
            for b in range(first, first + n):
                blk = getattr(resnet, f"Bottleneck_{b}")
                handles.append(blk.register_forward_hook(
                    hook((b, "out"), keep=b in (first, first + n - 1))))
                if b > first:
                    handles.append(blk.ConvBN_0.register_forward_hook(
                        hook((b, "y1"))))
                    handles.append(blk.ConvBN_1.register_forward_hook(
                        hook((b, "y2"))))
        first += n
    try:
        with torch.no_grad():
            resnet(images)
    finally:
        for h in handles:
            h.remove()
    return [dict(stage=s, x=kept[(b0, "out")], ref=kept[(last, "out")],
                 block_vars=block_vars_from_resnet(resnet, s),
                 act_scales=[{"in": amax[(b - 1, "out")],
                              "y1": amax[(b, "y1")], "y2": amax[(b, "y2")],
                              "out": amax[(b, "out")]}
                             for b in range(b0 + 1, last + 1)])
            for s, b0, last in stages]


# ResNet-50's four stride-1 chains: (blocks, width M, input channels);
# stage 1 follows the 64-channel stem and its block 0 has a projection.
RESNET50_CHAINS = ((3, 64, 64), (3, 128, 512), (5, 256, 1024),
                   (2, 512, 2048))


def resnet50_chain_convs(T=8, S=512):
    """``[(stage, P, Cin, Cout, ks)]`` of the 40 convs of ResNet-50's
    stride-1 chains on a ``T``-frame clip at ``S^2`` (stage s at
    ``S / 2^(s+1)``), in the order the chain runs them."""
    convs = []
    for stage, (blocks, M, cin) in enumerate(RESNET50_CHAINS, 1):
        side = S >> (stage + 1)
        P = T * side * side
        for b in range(blocks):
            convs += [(stage, P, cin, M, 1), (stage, P, M, M, 3)]
            if stage == 1 and b == 0:
                convs.append((stage, P, cin, 4 * M, 1))
            convs.append((stage, P, M, 4 * M, 1))
            cin = 4 * M
    return convs


def greedy_fixpoint(benefit, gate=None, neg=-1e9):
    """The greedy mutual-best fixpoint of ``tao_amodal_torch.ops.
    hungarian.greedy_assign`` in numpy on ``benefit [n, m]``, first-max-
    index ties, with every entry below ``gate`` (in f32) set to ``neg``
    first when ``gate`` is given.  Returns ``(row_to_col [n], rounds)``:
    -1 where unassigned, and the rounds that matched a pair."""
    b = np.where(benefit > neg / 2, benefit, neg).astype(np.float32)
    if gate is not None:
        b = np.where(b >= np.float32(gate), b, np.float32(neg))
    n, m = b.shape
    r2c, rounds = np.full(n, -1, np.int64), 0
    rows = np.arange(n)
    while n and m and (b.max(axis=1) > neg / 2).any():
        best_col, best_val = b.argmax(axis=1), b.max(axis=1)
        mutual = (b.argmax(axis=0)[best_col] == rows) & (best_val > neg / 2)
        r2c[mutual] = best_col[mutual]
        b[mutual, :] = neg
        b[:, best_col[mutual]] = neg
        rounds += 1
    return r2c, rounds


def auction_fixpoint(benefit, eps=5e-5, floor=-1e-3, max_iters=200_000,
                     neg=-1e9):
    """The auction of ``tao_amodal_torch.ops.hungarian.auction_assign``
    in numpy on ``benefit [n, m]``, round by round as the JAX
    ``while_loop`` runs it (first-max-index ties, f32).  Returns
    ``(row_to_col [n], rounds)``: -1 where unassigned, and the rounds
    run before no row was active (or ``max_iters``)."""
    f32 = np.float32
    eps, floor = f32(eps), f32(floor)
    n, m = benefit.shape
    r2c = np.full(n, -1, np.int64)
    if n == 0 or m == 0:
        return r2c, 0
    benefit = benefit.astype(f32)
    feasible = benefit > neg / 2
    has_option = feasible.any(1)
    minb = min(f32(np.where(feasible, benefit, np.inf).min()), f32(0))
    b = np.where(feasible, benefit - minb, f32(neg)).astype(f32)
    price = np.zeros(m, f32)
    retired = np.zeros(n, bool)
    rows, rounds = np.arange(n), 0
    while rounds < max_iters:
        active = (r2c < 0) & has_option & ~retired
        if not active.any():
            break
        value = b - price
        best_col = value.argmax(1)
        best_val = value[rows, best_col]
        masked = value.copy()
        masked[rows, best_col] = neg
        bid = best_val - np.maximum(masked.max(1), floor) + eps
        retire_now = active & (best_val < floor)
        retired |= retire_now
        bidding = active & ~retire_now
        bids = np.full((n, m), -np.inf, f32)
        bids[rows[bidding], best_col[bidding]] = bid[bidding]
        win_row = bids.argmax(0)
        contested = bids.max(0) > -np.inf
        r2c[(r2c >= 0) & contested[np.maximum(r2c, 0)]] = -1
        r2c[win_row[contested]] = np.nonzero(contested)[0]
        price = np.where(contested, price + bids.max(0), price).astype(f32)
        rounds += 1
    return r2c, rounds


def sort_rounds(state, clips, iou_threshold=0.3, **kw):
    """Greedy rounds per frame of the plain SORT loop over ``clips``
    (``[(boxes [T, D, 4], valid [T, D])]``, the state threaded), run on
    host copies: ``[(ungated, gated)]``, the rounds of each frame's
    benefit as the loop builds it, and with the benefits below
    ``iou_threshold`` set to NEG first."""
    from tao_amodal_torch.ops import sort_scan
    from tao_amodal_torch.trackers import sort

    seen = []
    real = sort.greedy_assign

    def record(benefit, *args, **kwargs):
        seen.append(benefit.numpy().copy())
        return real(benefit, *args, **kwargs)

    state = type(state)(*(t.cpu() for t in state))
    sort.greedy_assign = record
    try:
        for boxes, valid in clips:
            state, _ = sort_scan.sort_scan_torch(
                state, boxes.cpu(), valid.cpu(),
                iou_threshold=iou_threshold, **kw)
    finally:
        sort.greedy_assign = real
    return [(greedy_fixpoint(b)[1], greedy_fixpoint(b, iou_threshold)[1])
            for b in seen]


def tie_scene(seed, clips=3, T=8, D=64):
    """``clips`` ``(boxes [T, D, 4], valid [T, D])`` numpy clips of a
    static scene of 13-px squares at integer positions, all D valid a
    frame, rich in ties: 36 anchors on a 40-px grid (each missed now and
    then), copies of them offset by 7 px (IoU exactly 0.3, the SORT gate,
    with the anchor's track: 78 / 260), by 3 px, exact duplicates (tied
    rows), and squares far from every anchor (IoU 0 with their tracks),
    shuffled.  A track born of a square and updated with the same square
    stays exact (zero velocity, side and aspect exact in f32), so the
    gate's ties reach the association; the slots fill up, so births
    also run out of free slots."""
    rs = np.random.RandomState(seed)
    side = 13.0
    anchors = [(40.0 * i, 40.0 * j) for i in range(6) for j in range(6)]
    out = []
    for _ in range(clips):
        frames = []
        for _ in range(T):
            xy = [p for p in anchors if rs.rand() > 0.1]
            while len(xy) < D:
                x, y = anchors[rs.randint(len(anchors))]
                kind = rs.randint(4)
                if kind == 0:
                    xy.append((x + 7.0 * rs.choice([-1, 1]), y))
                elif kind == 1:
                    xy.append((x, y + 3.0))
                elif kind == 2:
                    xy.append((x, y))
                else:
                    xy.append((1000.0 + 20 * rs.randint(8),
                               1000.0 + 20 * rs.randint(8)))
            xy = np.array(xy[:D], np.float32)[rs.permutation(D)]
            frames.append(np.concatenate([xy, xy + side], -1))
        out.append((np.stack(frames), np.ones((T, D), bool)))
    return out
