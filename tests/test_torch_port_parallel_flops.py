"""The port's FLOP counter (``tao_amodal_torch/utils/flops.py``, the
numerator of the benchmark's model FLOP utilisation) held against the
JAX package's jaxpr walk (``tao_amodal_tpu/utils/flops.py``) on the same
shapes: matrix products, an einsum, convolutions (grouped too), the
ResNet-50 trunk with its FPN at 64^2 and the whole detector of the
CPU tests' architecture, equal; the trunk at 224^2 within 5 % of
``resnet50_reference_flops`` (``tests/test_flops.py``'s band); a grouped
convolution's backward counted per group.  The port counts on meta
tensors (shapes only) or on the CPU (every kernel wrapper's plain
version), as JAX traces without running."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_fixtures import (
    S,
    T,
    jax_pipeline,
    one_torch_thread,
    save_npz,
    torch_pipeline,
)

from tao_amodal_torch.models.backbones import ResNet
from tao_amodal_torch.models.fpn import FPN
from tao_amodal_torch.utils.flops import (
    count_flops,
    flop_counter,
    resnet50_reference_flops,
)
from tao_amodal_tpu.models.backbones import ResNet as JaxResNet
from tao_amodal_tpu.models.fpn import FPN as JaxFPN
from tao_amodal_tpu.utils.flops import count_flops as jax_count_flops

module_threads = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)


def meta(*shape):
    return torch.empty(shape, device="meta")


def spec(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def jax_conv(x, w, groups=1):
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", feature_group_count=groups,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("case", ["matmul", "einsum", "conv", "grouped"])
def test_closed_forms_match_jax(case):
    if case == "matmul":
        got = count_flops(torch.matmul, meta(64, 128), meta(128, 32))
        want = jax_count_flops(jnp.matmul, spec(64, 128), spec(128, 32))
        assert got == 2 * 64 * 128 * 32
    elif case == "einsum":
        got = count_flops(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                          meta(4, 8, 16), meta(4, 16, 5))
        want = jax_count_flops(
            lambda a, b: jnp.einsum("bik,bkj->bij", a, b), spec(4, 8, 16),
            spec(4, 16, 5))
    elif case == "conv":
        got = count_flops(lambda x, w: F.conv2d(x, w, padding=1),
                          meta(2, 8, 32, 32), meta(16, 8, 3, 3))
        want = jax_count_flops(jax_conv, spec(2, 32, 32, 8),
                               spec(3, 3, 8, 16))
    else:
        got = count_flops(lambda x, w: F.conv2d(x, w, padding=1, groups=4),
                          meta(1, 16, 8, 8), meta(16, 4, 3, 3))
        want = jax_count_flops(lambda x, w: jax_conv(x, w, 4),
                               spec(1, 8, 8, 16), spec(3, 3, 4, 16))
    assert got == want > 0


def test_trunk_and_fpn_match_jax():
    """ResNet-50 (3,4,6,3) and FPN-256 on one 64^2 frame."""
    stages = (3, 4, 6, 3)
    trunk, fpn = JaxResNet(stage_sizes=stages), JaxFPN(features=256)
    key = jax.random.PRNGKey(0)
    x = spec(1, 64, 64, 3)
    tv = jax.eval_shape(trunk.init, key, x)
    fv = jax.eval_shape(fpn.init, key, jax.eval_shape(trunk.apply, tv, x))
    want = jax_count_flops(
        lambda a, b, c: fpn.apply(b, trunk.apply(a, c)), tv, fv, x)

    port_trunk = ResNet(stage_sizes=stages).to("meta").eval()
    port_fpn = FPN((512, 1024, 2048), features=256).to("meta").eval()
    with torch.no_grad():
        got = count_flops(lambda v: port_fpn(port_trunk(v)),
                          meta(1, 3, 64, 64))
        trunk_only = count_flops(port_trunk, meta(1, 3, 64, 64))
    want_trunk = jax_count_flops(lambda a, c: trunk.apply(a, c), tv, x)
    assert got == want
    assert trunk_only == want_trunk < got


def test_r50_trunk_matches_literature_anchor():
    trunk = ResNet(stage_sizes=(3, 4, 6, 3)).to("meta").eval()
    with torch.no_grad():
        counted = count_flops(trunk, meta(1, 3, 224, 224))
    assert counted == pytest.approx(resnet50_reference_flops(224, 224),
                                    rel=0.05)


def test_detector_matches_jax(tmp_path):
    """The CPU tests' detector over a clip of T frames: the
    port on the CPU, JAX traced; no matrix product sits in a loop."""
    pipe, variables = jax_pipeline(seed=1, pooling="packed")
    want = jax_count_flops(
        lambda v, c: pipe.detector.apply(v, c), variables["detector"],
        spec(T, S, S, 3))
    port = torch_pipeline(save_npz(tmp_path, variables), pooling="packed")
    clip = torch.from_numpy(np.random.RandomState(0).randn(
        T, S, S, 3).astype(np.float32))
    with torch.no_grad():
        got = count_flops(port.detector, clip)
    assert got == want > 0


def test_grouped_conv_backward_counts_per_group():
    """A depthwise 3x3 (64 groups) forward and backward: the input and
    the weight gradients each cost the forward's FLOPs (PyTorch's own
    formula counts the weight gradient 64 times over)."""
    x = torch.randn(2, 64, 16, 16, requires_grad=True)
    w = torch.randn(64, 1, 3, 3, requires_grad=True)
    fwd = 2 * (2 * 64 * 16 * 16) * 9
    with flop_counter() as counter:
        F.conv2d(x, w, padding=1, groups=64).sum().backward()
    assert counter.get_total_flops() == 3 * fwd
