"""Shared set-up for the PyTorch port's parity tests.

The small architecture of every ``test_torch_port_*`` file, the JAX
variables it is held against (a real ``AmodalPipeline.init``, then every
BatchNorm statistic, bias and the zero-initialised expander ``deltas``
layer perturbed with seeded numpy noise, so that no bridged tensor is a
trivial identity), and the bridge through ``save_pytree`` -> npz ->
``tao_amodal_torch.utils.weights``.
"""

import jax
import jax.numpy as jnp
import numpy as np

TINY = dict(num_classes=8, num_dets=8, num_proposals=16,
            backbone_stages=(1, 1, 1, 1))
T, S = 4, 64


def perturb(tree, rng):
    """Seeded noise on every leaf that Flax initialises to a constant."""
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
