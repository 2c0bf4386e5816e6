"""Shared set-up for the PyTorch port's parity tests.

The small architecture of every ``test_torch_port_*`` file, the JAX
variables it is held against (a real ``AmodalPipeline.init``, then every
BatchNorm statistic, bias and the zero-initialised expander ``deltas``
layer perturbed with seeded numpy noise, so that no bridged tensor is a
trivial identity), the bridge through ``save_pytree`` -> npz ->
``tao_amodal_torch.utils.weights``, and seeded numpy inputs (clips,
frame files, coherent SORT scenes, bottleneck chains).

jax is imported inside the functions that need it, so that the
jax-free ``test_torch_port_isolation.py`` and ``chip_smoke.py`` can
use the numpy helpers on a machine without jax.
"""

import numpy as np

TINY = dict(num_classes=8, num_dets=8, num_proposals=16,
            backbone_stages=(1, 1, 1, 1))
T, S = 4, 64


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
    """(JAX AmodalPipeline, perturbed variables as numpy)."""
    import jax
    import jax.numpy as jnp

    from tao_amodal_tpu.pipeline import AmodalPipeline

    pipe = AmodalPipeline.create(**{**TINY, **overrides})
    variables = jax.jit(pipe.init)(jax.random.PRNGKey(seed),
                                   jnp.zeros((T, S, S, 3)))
    return pipe, perturb(variables, np.random.RandomState(seed + 100))


def save_npz(tmp_path, variables, name="pipeline.npz"):
    from tao_amodal_tpu.utils.checkpoint import save_pytree

    path = str(tmp_path / name)
    save_pytree(path, variables)
    return path


def torch_pipeline(npz_path, **overrides):
    from tao_amodal_torch.pipeline import AmodalPipeline

    return AmodalPipeline.create(**{**TINY, **overrides}).load(npz_path)


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
