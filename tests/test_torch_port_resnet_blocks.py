"""The port's identity-bottleneck stacks (kernels B7 and B8 and their
plain versions) held against the JAX package on the CPU, where the
wrappers take the plain versions: the int8 stack against the JAX integer
reference and its Pallas kernel in interpret mode, the bf16 stack
against the JAX reference, both param folding functions on one
``block_vars``, the ``block_vars`` bridge from the port's ``ResNet``,
and PTQ fidelity
against the port's f32 trunk.  The kernels themselves are held against
the plain versions on the card by ``test_torch_port_isolation.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tao_amodal_tpu.models.backbones import ResNet as JaxResNet
from tao_amodal_tpu.ops.pallas import resnet_blocks as jrb
from tao_amodal_torch.models.backbones import ResNet
from tao_amodal_torch.ops import resnet_blocks as trb
from tao_amodal_torch.utils import weights
from torch_port_fixtures import (
    perturb,
    perturb_module,
    stack_arrays,
    stage_stacks,
    torch_stack,
)


def _jax_params(params, kind):
    if kind == "int8":
        return jrb.QuantBlockParams(*(jnp.asarray(a) for a in params))
    return jrb.Bf16BlockParams(*(
        jnp.asarray(a, jnp.bfloat16 if i % 3 == 0 else jnp.float32)
        for i, a in enumerate(params)))


@pytest.mark.parametrize("shape,M,N", [((2, 16, 16, 64), 16, 2),
                                       ((2, 12, 12, 64), 16, 3)])
def test_int8_stack_matches_jax_exactly(shape, M, N):
    """Exact (as ``tests/test_resnet_blocks.py:39``): the dots are exact
    integers on both sides and every requantization rounds the same f32
    values.  The JAX params reach the port through
    ``block_params_from_jax``."""
    x, params = stack_arrays(shape, M, N, "int8", seed=N)
    jp = _jax_params(params, "int8")
    want = np.asarray(jrb.identity_blocks_reference(jnp.asarray(x), jp))
    kernel = np.asarray(jrb.identity_blocks_pallas(jnp.asarray(x), jp,
                                                   interpret=True))
    tp = weights.block_params_from_jax(type(jp)(*map(np.asarray, jp)))
    before = trb.identity_blocks_pallas.launches
    got = trb.identity_blocks_pallas(torch.from_numpy(x), tp)
    assert trb.identity_blocks_pallas.launches == before
    assert got.dtype == torch.int8 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), kernel)
    assert 0 < (want > 0).mean() < 1  # neither all clipped nor all zero


def bf16_bound(got, want):
    """The B8 tolerance: max |d| <= 1e-2 max|ref| and mean |d| <= 1e-3
    mean|ref| (f32 sums in another order can flip a bf16 rounding by one
    ulp, and a flip propagates through the later blocks).  Returns the
    share of elements that are exactly equal."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want)
    assert d.max() <= 1e-2 * np.abs(want).max(), d.max()
    assert d.mean() <= 1e-3 * np.abs(want).mean(), d.mean()
    return float((d == 0).mean())


def test_bf16_stack_matches_jax():
    """The bf16 bound of :func:`bf16_bound`; the share of equal elements
    is printed."""
    x, params = stack_arrays((2, 12, 12, 64), 16, 3, "bf16", seed=2)
    jp = _jax_params(params, "bf16")
    want = np.asarray(jrb.identity_blocks_bf16_reference(
        jnp.asarray(x, jnp.bfloat16), jp), np.float32)
    tx, tp = torch_stack("cpu", x, params, "bf16")
    got = trb.identity_blocks_bf16_pallas(tx, tp)
    assert got.dtype == torch.bfloat16
    equal = bf16_bound(got.float().numpy(), want)
    print(f"bf16 stack vs JAX: {equal:.4f} of elements equal")
    assert equal > 0.9


def _block_vars(rs, n, C, M):
    """Random identity-bottleneck ``block_vars`` with non-trivial BN."""
    def bn(c):
        return (rs.uniform(0.5, 1.5, c).astype(np.float32),
                (0.1 * rs.randn(c)).astype(np.float32),
                (0.1 * rs.randn(c)).astype(np.float32),
                rs.uniform(0.5, 1.5, c).astype(np.float32))

    return [{"conv1/kernel": (rs.randn(1, 1, C, M) * 0.1).astype(np.float32),
             "bn1": bn(M),
             "conv2/kernel": (rs.randn(3, 3, M, M) * 0.1).astype(np.float32),
             "bn2": bn(M),
             "conv3/kernel": (rs.randn(1, 1, M, C) * 0.1).astype(np.float32),
             "bn3": bn(C)} for _ in range(n)]


def _assert_params_equal(got, want, rtol=0.0):
    assert type(got).__name__ == type(want).__name__
    for field, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, field
            g, w = g.view(torch.int16), w.view(np.int16)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=0,
                                       err_msg=field)


def test_param_folding_matches_jax():
    """``quantize_bottleneck_params`` (numpy on both sides) on one
    ``block_vars``: equal bit for bit.  ``bf16_params_from_bottlenecks``:
    the bf16 weights equal bit for bit; the f32 BN fold within rtol 1e-6
    (a few ulp), since XLA rewrites ``scale / sqrt(var + eps)`` with an
    approximate reciprocal square root while the port divides."""
    rs = np.random.RandomState(0)
    bvs = _block_vars(rs, 3, 64, 16)
    scales = [{"in": 0.02 + 0.01 * i, "y1": 0.03, "y2": 0.04 + 0.01 * i,
               "out": 0.03 + 0.01 * i} for i in range(3)]
    _assert_params_equal(
        trb.quantize_bottleneck_params(bvs, scales, 0.02, 0.05),
        jrb.quantize_bottleneck_params(bvs, scales, 0.02, 0.05))
    _assert_params_equal(trb.bf16_params_from_bottlenecks(bvs),
                         jrb.bf16_params_from_bottlenecks(bvs), rtol=1e-6)


def test_block_vars_from_resnet_round_trips_the_bridge():
    """A JAX ``ResNet`` with perturbed BN, bridged into the port's
    ``ResNet`` through the npz bridge: ``block_vars_from_resnet`` gives
    back the JAX variables of each stage's identity blocks exactly, in
    the layout the JAX test reads them (``tests/test_resnet_blocks.py``
    ``:72-83``)."""
    stages = (2, 3, 2, 2)
    rs = np.random.RandomState(1)
    x = rs.randn(1, 64, 64, 3).astype(np.float32)
    jnet = JaxResNet(stage_sizes=stages)
    variables = perturb(jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                           jnp.asarray(x)), rs)
    flat = {}
    for col, tree in variables.items():
        for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[f"backbone/{col}/" + "/".join(p.key for p in k)] = (
                np.asarray(v))
    holder = nn.Module()
    holder.backbone = ResNet(stage_sizes=stages)
    weights.load_into(holder, flat)

    params, stats = variables["params"], variables["batch_stats"]
    first = 0
    for stage, n in enumerate(stages, 1):
        got = weights.block_vars_from_resnet(holder.backbone, stage)
        assert len(got) == n - 1
        for bv, b in zip(got, range(first + 1, first + n)):
            bp, bs = params[f"Bottleneck_{b}"], stats[f"Bottleneck_{b}"]
            for j in (1, 2, 3):
                cb = f"ConvBN_{j - 1}"
                np.testing.assert_array_equal(
                    bv[f"conv{j}/kernel"], bp[cb]["Conv_0"]["kernel"])
                want = (bp[cb]["BatchNorm_0"]["scale"],
                        bp[cb]["BatchNorm_0"]["bias"],
                        bs[cb]["BatchNorm_0"]["mean"],
                        bs[cb]["BatchNorm_0"]["var"])
                for g, w in zip(bv[f"bn{j}"], want):
                    np.testing.assert_array_equal(g, w)
        first += n


def test_quantized_stacks_track_f32_trunk():
    """PTQ fidelity of the port's stacks on its own trunk: stage 1 of a
    small ``ResNet`` (C=256, M=64, 2 identity blocks, 12x12 frames) with
    perturbed BN, its block-0 output fed to the int8 stack (scales
    calibrated as abs-max/127 of the f32 run) and to the bf16 stack.
    Cosine > 0.995 and relative error < 0.1 against the f32 stage
    output, the JAX test's bounds (``tests/test_resnet_blocks.py:112-117``).
    """
    torch.manual_seed(0)
    net = ResNet(stage_sizes=(3, 1, 1, 1))
    weights.random_init_(net, torch.Generator().manual_seed(3))
    perturb_module(net, np.random.RandomState(4))
    images = torch.from_numpy(
        np.random.RandomState(5).randn(2, 3, 48, 48).astype(np.float32))
    st, = stage_stacks(net.eval(), images)
    assert st["stage"] == 1 and tuple(st["x"].shape) == (2, 12, 12, 256)
    scales = st["act_scales"]
    qp = trb.quantize_bottleneck_params(st["block_vars"], scales,
                                        scales[0]["in"], scales[-1]["out"])
    x_q = torch.round(st["x"] / scales[0]["in"]).clamp(0, 127).to(
        torch.int8)
    out = trb.identity_blocks_pallas(x_q, qp).float() * scales[-1]["out"]
    bp = trb.bf16_params_from_bottlenecks(st["block_vars"])
    out_bf16 = trb.identity_blocks_bf16_pallas(
        st["x"].to(torch.bfloat16), bp).float()
    ref = st["ref"]
    for got in (out, out_bf16):
        cos = float((got * ref).sum() / (got.norm() * ref.norm() + 1e-9))
        rel = float((got - ref).abs().mean() / (ref.abs().mean() + 1e-9))
        assert cos > 0.995 and rel < 0.1, (cos, rel)
