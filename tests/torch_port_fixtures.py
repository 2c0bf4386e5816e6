"""Shared set-up for the PyTorch port's parity tests.

The small architecture of every ``test_torch_port_*`` file, the JAX
variables it is held against (a real ``AmodalPipeline.init``, then every
BatchNorm statistic, bias and the zero-initialised expander ``deltas``
layer perturbed with seeded numpy noise, so that no bridged tensor is a
trivial identity), the bridge through ``save_pytree`` -> npz ->
``tao_amodal_torch.utils.weights``, and seeded numpy inputs (clips,
frame files, coherent SORT scenes, bottleneck chains, a GTR-named
detector checkpoint), and the greedy rounds of SORT's association
counted on the host.

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


def resnet50_chain_convs(T=8, S=512, W=None):
    """``[(stage, P, Cin, Cout, ks)]`` of the 40 convs of ResNet-50's
    stride-1 chains on a ``T``-frame clip at ``S^2`` (or ``S x W``; stage
    s at ``S / 2^(s+1)``), in the order the chain runs them."""
    convs = []
    for stage, (blocks, M, cin) in enumerate(RESNET50_CHAINS, 1):
        P = T * (S >> (stage + 1)) * ((W or S) >> (stage + 1))
        for b in range(blocks):
            convs += [(stage, P, cin, M, 1), (stage, P, M, M, 3)]
            if stage == 1 and b == 0:
                convs.append((stage, P, cin, 4 * M, 1))
            convs.append((stage, P, M, 4 * M, 1))
            cin = 4 * M
    return convs


def resnet50_trunk_convs(T=8, S=512):
    """``[(stage, Hi, Wi, Cin, Cout, ks, stride)]`` of the 53 convs of the
    int8 ResNet-50 trunk (the classic stem) on a ``T``-frame clip at
    ``S^2``, in the order it runs them: the 7x7/2 stem, then per block
    its 1x1, 3x3 (stride 2 in the first block of stages 2-4), 1x1 and,
    in each stage's first block, the projection."""
    convs = [(0, S, S, 3, 64, 7, 2)]
    side, cin = S // 4, 64
    for stage, (blocks, M) in enumerate(((3, 64), (4, 128), (6, 256),
                                         (3, 512)), 1):
        for b in range(blocks):
            s = 2 if b == 0 and stage > 1 else 1
            convs += [(stage, side, side, cin, M, 1, 1),
                      (stage, side, side, M, M, 3, s),
                      (stage, side // s, side // s, M, 4 * M, 1, 1)]
            if b == 0:
                convs.append((stage, side, side, cin, 4 * M, 1, s))
            side, cin = side // s, 4 * M
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


def sequential_greedy(benefit, neg=-1e9):
    """Sequential greedy on ``benefit [n, m]`` in numpy: the open entry
    that is largest, ties by row and then column, taken one at a time
    (its row and column closed), while one above ``neg / 2`` is open.
    The mutual-best rounds of :func:`greedy_fixpoint` reach this
    matching (first-index argmaxes of rows and columns agree with that
    order), which is what lets ``csrc/fixpoint.cu`` take a plateau of
    equal values in one walk.  Returns ``row_to_col [n]``."""
    b = np.where(benefit > neg / 2, benefit, neg).astype(np.float32)
    b = b + np.float32(0.0)  # -0 as +0: the two are equal values
    r2c = np.full(b.shape[0], -1, np.int64)
    while b.size and b.max() > neg / 2:
        flat = int(np.argmax(b))  # row-major: ties by row, then column
        i, j = divmod(flat, b.shape[1])
        r2c[i] = j
        b[i, :] = neg
        b[:, j] = neg
    return r2c


def iou_np(a, b):
    """IoU of xyxy boxes ``a [n, 4]`` against ``b [m, 4]`` in f32."""
    a, b = a.astype(np.float32)[:, None], b.astype(np.float32)[None]
    iw = np.clip(np.minimum(a[..., 2], b[..., 2])
                 - np.maximum(a[..., 0], b[..., 0]), 0, None)
    ih = np.clip(np.minimum(a[..., 3], b[..., 3])
                 - np.maximum(a[..., 1], b[..., 1]), 0, None)
    inter = iw * ih
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
    return (inter / (area(a) + area(b) - inter)).astype(np.float32)


def prroi_edge_rois(Hc, Wc):
    """RoIs ``[16][4]`` (xyxy, map coordinates) that PrRoI pooling on an
    ``[Hc, Wc]`` map must take: crossing each edge, of zero area (the
    1e-8 bin clamp), on the whole map and past it, small ones, wholly
    outside the map, spanning every column, a point inside it and a
    sliver."""
    return [[-3.0, 2.0, 8.0, 9.5], [Wc - 6.5, Hc - 5.0, Wc + 4.0, Hc + 2.0],
            [4.0, -2.5, 11.0, 3.0], [5.0, 5.0, 5.0, 5.0],
            [7.25, 3.0, 7.25, 10.0], [2.0, 6.5, 9.0, 6.5],
            [0.0, 0.0, float(Wc), float(Hc)],
            [-10.0, -10.0, Wc + 10.0, Hc + 10.0],
            [10.3, 4.7, 12.1, 5.9], [1.0, 1.0, 3.5, 2.0],
            [-40.0, -30.0, -20.0, -10.0], [Wc + 5.0, 3.0, Wc + 9.0, 8.0],
            [0.0, 10.0, float(Wc), 12.5], [-0.5, 0.0, Wc + 0.5, 1.0],
            [Wc / 2, Hc / 2, Wc / 2, Hc / 2],
            [Wc / 2 + 0.5, 7.25, Wc / 2 + 0.75, Hc - 8.0]]


def nms_bits(boxes, scores, thr, valid=None):
    """The suppression words of ``csrc/fixpoint.cu::nms_bits_kernel`` in
    numpy: ``boxes [B, n, 4]`` and ``scores [B, n]`` f32, ``valid [B, n]``
    bool or None (all valid), the threshold compared in f32 ->
    ``uint32 [B, ceil(n / 32), n]``, word-major: bit k of word ``[b, w,
    j]`` is ``sup[b, 32 w + k, j]``, box ``32 w + k`` ranks above ``j``
    (score, then index), is valid and overlaps ``j`` past the threshold.
    Each entry follows the kernel: rows that do not rank above ``j`` or
    are not valid are skipped, and where the intersection is not > 0 the
    IoU is 0 without a division; otherwise ``box_iou_xyxy``'s f32 ops in
    order, NaN propagating through max, min and the clamps."""
    b = np.asarray(boxes, np.float32)
    s = np.asarray(scores, np.float32)
    B, n = s.shape
    v = np.ones((B, n), bool) if valid is None else np.asarray(valid, bool)
    thr = np.float32(thr)
    p, q = b[:, :, None], b[:, None, :]         # rows i, columns j
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        def clamp0(x):
            return np.where(x < 0, np.float32(0), x)
        iw = clamp0(np.minimum(p[..., 2], q[..., 2])
                    - np.maximum(p[..., 0], q[..., 0]))
        ih = clamp0(np.minimum(p[..., 3], q[..., 3])
                    - np.maximum(p[..., 1], q[..., 1]))
        inter = iw * ih
        area = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
        union = (area[:, :, None] + area[:, None, :]) - inter
        overlap = inter > 0
        pos = overlap & (union > 0)
        iou = np.zeros_like(inter)
        iou[pos] = inter[pos] / union[pos]   # divided only where needed
        hit = np.where(overlap, iou > thr, np.float32(0) > thr)
    idx = np.arange(n)
    si, sj = s[:, :, None], s[:, None, :]
    ranked = (si > sj) | ((si == sj) & (idx[:, None] < idx[None, :]))
    return pack_sup(ranked & v[:, :, None] & hit)


def pack_sup(sup):
    """A bool suppression matrix ``[B, n, n]`` as :func:`nms_bits`'s
    words."""
    sup = np.asarray(sup, bool)
    B, n, _ = sup.shape
    words = -(-n // 32)
    pad = np.zeros((B, 32 * words, n), bool)
    pad[:, :n] = sup
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    return (pad.reshape(B, words, 32, n).astype(np.uint64)
            * weights[:, None]).sum(axis=2).astype(np.uint32)


def _clustered_boxes(rs, B, n, extent=200.0, spread=8.0):
    centre = rs.uniform(20, extent, (B, 4, 2))
    pick = rs.randint(0, 4, (B, n))
    xy = np.take_along_axis(centre, pick[..., None], 1) + rs.randn(
        B, n, 2) * spread
    wh = rs.uniform(20, 60, (B, n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# Names of :func:`nms_adversarial`'s scenes, in its order.
NMS_SCENES = ("nan_inf", "zero_area", "identical_ties", "threshold_edge",
              "rpn", "detector")


def nms_adversarial(name, seed=0):
    """``(boxes [B, n, 4], scores [B, n], valid [B, n] or None, thr)`` of
    one NMS scene the kernel must match its plain version on (f32):

    - ``nan_inf``: clustered boxes with NaN and +-inf coordinates (boxes
      decoded from random weights overflow), tied scores, invalid boxes;
    - ``zero_area``: boxes of zero width or height, points, negative
      extents and identical zero-area boxes, at thresholds 0;
    - ``identical_ties``: groups of identical boxes with tied scores, so
      the index breaks every tie;
    - ``threshold_edge``: pairs whose IoU is exactly f32(0.1) (1 / 10)
      at the threshold 0.1, whose f32 value lies above 0.1;
    - ``rpn``: the RPN's call (``models/rpn.py``): [8, 448] at 0.7, five
      levels of anchors jittered and clamped to the 512-pixel image
      (boxes on its edges collapse to zero width), sigmoid scores;
    - ``detector``: the detector's class-aware call: [8, 96] at 0.5, the
      boxes offset by class x 1e5 in f32 (``ops/nms.py::
      class_aware_nms``), scores with many tied zeros.
    """
    rs = np.random.RandomState(seed + NMS_SCENES.index(name))
    if name == "nan_inf":
        boxes = _clustered_boxes(rs, 2, 40)
        odd = np.float32([np.nan, np.inf, -np.inf])
        for b in range(2):
            at = rs.choice(40, 12, replace=False)
            boxes[b, at, rs.randint(0, 4, 12)] = odd[rs.randint(0, 3, 12)]
        boxes[0, 5] = np.inf
        boxes[1, 7] = [-np.inf, -np.inf, np.inf, np.inf]
        boxes[1, 8] = [0, 0, np.inf, 50]
        boxes[1, 9] = [0, 0, np.inf, 50]
        scores = np.round(rs.rand(2, 40), 1).astype(np.float32)
        return boxes, scores, rs.rand(2, 40) > 0.1, 0.3
    if name == "zero_area":
        boxes = _clustered_boxes(rs, 2, 36)
        boxes[:, :6, 2] = boxes[:, :6, 0]           # zero width
        boxes[:, 6:12, 3] = boxes[:, 6:12, 1]       # zero height
        boxes[:, 12:16, 2:] = boxes[:, 12:16, :2]   # points
        boxes[:, 16:20] = boxes[:, 16:20, [2, 3, 0, 1]]  # negative extents
        boxes[:, 20:24] = boxes[:, 0:1]             # identical, zero area
        scores = np.round(rs.rand(2, 36), 1).astype(np.float32)
        return boxes, scores, None, 0.0
    if name == "identical_ties":
        base = _clustered_boxes(rs, 2, 6)
        boxes = base[:, rs.randint(0, 6, 48)]
        scores = rs.randint(0, 3, (2, 48)).astype(np.float32) / 4
        return boxes, scores, rs.rand(2, 48) > 0.1, 0.5
    if name == "threshold_edge":
        n = 32
        x = np.arange(n // 2, dtype=np.float32)[:, None] * 100
        a = np.concatenate([x, 0 * x, x + 5.5, 0 * x + 1], 1)
        b = np.concatenate([x + 4.5, 0 * x, x + 10, 0 * x + 1], 1)
        boxes = np.stack([a, b], 1).reshape(1, n, 4).astype(np.float32)
        scores = rs.rand(1, n).astype(np.float32)
        return boxes, scores, None, 0.1
    if name == "rpn":
        T, sizes = 8, (100, 100, 100, 100, 48)
        parts = []
        for level, k in enumerate(sizes):
            side = 32.0 * 2 ** level
            cxy = rs.uniform(0, 512, (T, k, 2))
            wh = side * np.exp(rs.randn(T, k, 2) * 0.3)
            parts.append(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1))
        boxes = np.clip(np.concatenate(parts, 1), 0, 512).astype(np.float32)
        logits = rs.randn(T, sum(sizes)).astype(np.float32)
        scores = (1 / (1 + np.exp(-logits))).astype(np.float32)
        return boxes, scores, None, 0.7
    if name == "detector":
        T, n = 8, 96
        boxes = _clustered_boxes(rs, T, n, extent=400.0, spread=20.0)
        classes = rs.randint(0, 8, (T, n)).astype(np.float32)
        boxes = (boxes + classes[..., None] * np.float32(1e5)).astype(
            np.float32)
        scores = rs.rand(T, n).astype(np.float32)
        scores[rs.rand(T, n) < 0.3] = 0.0
        return boxes, scores, None, 0.5
    raise ValueError(name)


def sort_benefits(seed, n=64, m=128, frames=4):
    """SORT-like benefits ``[n, m]`` as ``sort_step`` builds them: the
    IoU (in [0, 1]) of ``n`` detection slots against ``m`` track slots,
    NEG where the detection is invalid or the slot dead; a scene of
    boxes on a 512-pixel canvas, the tracks the detections shifted a few
    pixels with some duplicated (exact ties) and some far away, so most
    entries are a plateau of zeros.  Yields ``frames`` of them."""
    rs = np.random.RandomState(seed)
    for _ in range(frames):
        xy = rs.uniform(0, 448, (n, 2))
        wh = rs.uniform(8, 64, (n, 2))
        dets = np.concatenate([xy, xy + wh], 1)
        src = rs.randint(0, n, m)
        trk = dets[src] + rs.uniform(-6, 6, (m, 4))
        trk[rs.rand(m) < 0.3] += 1000.0  # tracks far from every detection
        dup = rs.rand(m) < 0.1
        trk[dup] = dets[src[dup]]  # an IoU of exactly 1, tied across slots
        b = iou_np(dets, trk)
        b[rs.rand(n) < 0.25, :] = -1e9  # invalid detections
        b[:, rs.rand(m) < 0.3] = -1e9  # dead slots
        yield b.astype(np.float32)


def greedy_adversarial(seed):
    """Benefits the greedy kernel must match its plain version on: tie
    plateaus of equal values and of zeros (and -0), rows and columns all
    NEG, n > m and n < m, chains ``1 - (i + j) / 1000`` that need n
    rounds, shapes from 1x1 to 128x256, and two past a block's shared
    memory (read where they lie)."""
    rs = np.random.RandomState(seed)
    shapes = ((1, 1), (1, 7), (9, 1), (3, 40), (40, 3), (64, 128),
              (128, 64), (128, 256), (256, 128), (100, 100))
    for n, m in shapes:
        yield rs.rand(n, m).astype(np.float32)
        q = (rs.randint(0, 3, (n, m)) / 2).astype(np.float32)
        q[rs.rand(n, m) < 0.2] = -0.0
        q[rs.rand(n) < 0.2, :] = -1e9
        q[:, rs.rand(m) < 0.2] = -1e9
        yield q
        z = np.zeros((n, m), np.float32)
        z[rs.rand(n, m) < 0.3] = -1e9
        yield z
        i, j = np.meshgrid(np.arange(n), np.arange(m), indexing="ij")
        yield (1 - (i + j) * 1e-3).astype(np.float32)
    yield rs.rand(300, 257).astype(np.float32)
    yield np.zeros((260, 256), np.float32)


def auction_adversarial(seed):
    """Benefits the auction kernel must match its plain version on, for
    both of SORT's settings: random payoffs, tie-rich ones (four levels,
    -0, rows and columns all NEG), price wars (payoffs within 1e-3 of
    each other: many rounds at eps 5e-5), shapes from 1x1 (m = 1: the
    second value is the floor) to SORT's [64, 128], negative payoffs with
    NaN and -inf, a matrix with nothing feasible, SORT-like frames
    (:func:`sort_benefits`) and one past 48 KB of shared memory."""
    rs = np.random.RandomState(seed)
    for n, m in ((1, 1), (1, 9), (9, 1), (5, 40), (40, 5), (33, 33),
                 (64, 128)):
        yield rs.rand(n, m).astype(np.float32)
        q = (rs.randint(0, 4, (n, m)) / 4).astype(np.float32)
        q[rs.rand(n, m) < 0.2] = -0.0
        q[rs.rand(n) < 0.2, :] = -1e9
        q[:, rs.rand(m) < 0.2] = -1e9
        yield q
        yield (0.5 + 1e-3 * rs.rand(n, m)).astype(np.float32)
    # Negative payoffs (the shift by the feasible minimum matters), NaN and
    # -inf entries (forbidden, as NEG is), and nothing feasible at all.
    neg = rs.uniform(-1, 1, (20, 30)).astype(np.float32)
    neg[rs.rand(20, 30) < 0.1] = np.nan
    neg[rs.rand(20, 30) < 0.05] = -np.inf
    yield neg
    yield np.full((5, 7), -1e9, np.float32)
    yield from sort_benefits(seed, frames=2)
    yield rs.rand(120, 200).astype(np.float32)


def auction_chain(n):
    """A square benefit ``[n, n]`` whose auction is one round of all n
    rows, then a chain of n - 1 single-row rounds: rows 0 and 1 both want
    column 0 (row 1 wins it), row i >= 2 wants column i - 1 and next
    column i, so row 0's loss evicts row 2 from column 1, which evicts row
    3 from column 2, and so on until row n - 1 takes the free column
    n - 1."""
    b = np.zeros((n, n), np.float32)
    b[0, :2] = (0.9, 0.89)
    b[1, 0] = 0.95
    for i in range(2, n):
        b[i, i - 1] = 0.9
        b[i, i] = 0.89
    return b


def quantizer_cases(device, seed=1):
    """``[(x, act_scale)]``: activations the int8 quantizer must match its
    plain version on beside the trunk's, on ``device``: an NCHW tensor and
    non-dense NCHW views, channels-last views with strided pixels, a
    ragged channel count or an offset that breaks 16-byte alignment,
    3-channel stems, each in f32 and bf16 with a dynamic scale, a static
    one and a static one that clips; all-zero activations (the 1e-8
    floor) in both layouts."""
    import torch

    rs = np.random.RandomState(seed)
    base = torch.from_numpy(rs.randn(4, 40, 37, 66).astype(np.float32)).to(
        device)
    nhwc = base.permute(0, 2, 3, 1).contiguous()
    flat = torch.from_numpy(rs.randn(4 * 37 * 66 * 32 + 1).astype(
        np.float32)).to(device)
    views = [base, base[:, :, ::2, 1:], base[:, 3:30], base.transpose(2, 3),
             nhwc.permute(0, 3, 1, 2)[:, :, :, ::2],
             nhwc[..., :3].permute(0, 3, 1, 2),
             nhwc[..., 5:25].permute(0, 3, 1, 2),
             flat[1:].view(4, 37, 66, 32).permute(0, 3, 1, 2)]
    cases = [(v, act) for x in views for v in (x, x.to(torch.bfloat16))
             for act in (None, 0.0173, 0.002)]
    zeros = (torch.zeros((2, 64, 16, 16), device=device).contiguous(
        memory_format=torch.channels_last),
             torch.zeros((2, 3, 9, 9), device=device))
    return cases + [(z, None) for z in zeros]


def auction_fixpoint(benefit, eps=5e-5, floor=-1e-3, max_iters=200_000,
                     neg=-1e9, stats=None):
    """The auction of ``tao_amodal_torch.ops.hungarian.auction_assign``
    in numpy on ``benefit [n, m]``, round by round as the JAX
    ``while_loop`` runs it (first-max-index ties, f32).  Returns
    ``(row_to_col [n], rounds)``: -1 where unassigned, and the rounds
    run before no row was active (or ``max_iters``).  ``stats``, a dict,
    gains ``"active"``: the active rows summed over the rounds (the rows
    whose bids a round computes), and ``"per_round"``: the list of each
    round's active rows."""
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
        if stats is not None:
            stats["active"] = stats.get("active", 0) + int(active.sum())
            stats.setdefault("per_round", []).append(int(active.sum()))
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


def gtr_state_dict(seed, stage_sizes, num_classes, features=256, pool=7):
    """A GTR-named R50-FPN detector checkpoint (detectron2 names, the
    trunk under ``backbone.bottom_up.``, in a ``{"model": ...}`` container
    with DataParallel's ``module.`` prefix) of torch tensors at the given
    trunk depth, from a numpy seed: LeCun-scaled weights, BatchNorm
    statistics and affines and every bias perturbed; the trunk's convs
    have no bias."""
    rs = np.random.RandomState(seed)
    sd = {}

    def put(name, *shape, bias=True):
        sd[name] = rs.randn(*shape) * int(np.prod(shape[1:])) ** -0.5
        if bias:
            sd[name[:-len("weight")] + "bias"] = 0.05 * rs.randn(shape[0])

    def bn(name, c):
        sd[name + ".weight"] = 1 + 0.1 * rs.randn(c)
        sd[name + ".bias"] = 0.05 * rs.randn(c)
        sd[name + ".running_mean"] = 0.1 * rs.randn(c)
        sd[name + ".running_var"] = rs.uniform(0.5, 1.5, c)

    t = "backbone.bottom_up."
    put(t + "conv1.weight", 64, 3, 7, 7, bias=False)
    bn(t + "bn1", 64)
    cin, width = 64, 64
    outs = []
    for stage, blocks in enumerate(stage_sizes, 1):
        for b in range(blocks):
            p = f"{t}layer{stage}.{b}."
            for j, (co, ci, k) in enumerate(
                    ((width, cin, 1), (width, width, 3),
                     (4 * width, width, 1)), 1):
                put(f"{p}conv{j}.weight", co, ci, k, k, bias=False)
                bn(f"{p}bn{j}", co)
            if b == 0:
                put(p + "downsample.0.weight", 4 * width, cin, 1, 1,
                    bias=False)
                bn(p + "downsample.1", 4 * width)
            cin = 4 * width
        outs.append(cin)
        width *= 2
    for i, c in zip((3, 4, 5), outs[1:]):
        put(f"backbone.fpn_lateral{i}.weight", features, c, 1, 1)
        put(f"backbone.fpn_output{i}.weight", features, features, 3, 3)
    for i in (6, 7):
        put(f"backbone.top_block.p{i}.weight", features, features, 3, 3)
    r = "proposal_generator.rpn_head."
    put(r + "conv.weight", features, features, 3, 3)
    put(r + "objectness_logits.weight", 3, features, 1, 1)
    put(r + "anchor_deltas.weight", 12, features, 1, 1)
    h = "roi_heads."
    put(h + "box_head.fc1.weight", 1024, features * pool * pool)
    put(h + "box_head.fc2.weight", 1024, 1024)
    put(h + "box_predictor.cls_score.weight", num_classes + 1, 1024)
    put(h + "box_predictor.bbox_pred.weight", 4, 1024)
    import torch

    return {"model": {"module." + k: torch.from_numpy(
        np.asarray(v, np.float32)) for k, v in sd.items()}}


def one_torch_thread():
    """Generator for a module-scoped fixture: the module's tests run with
    one PyTorch CPU thread (the count restored after).  The int8 tests
    run many small convolutions beside JAX's compiles; under the test
    runner's parallel workers, a pool of threads per process starves the
    other workers' many small ops (a file of 12 s took minutes)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
