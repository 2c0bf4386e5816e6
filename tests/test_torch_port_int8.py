"""The int8 trunk of the port (``ClipDetector(int8_backbone=True)``) held
against the JAX package's on the CPU, conv by conv.

JAX's ``_int8_conv`` (``tao_amodal_tpu/models/backbones.py:58-84``) runs
op by op here, with every ``ConvBN``'s input and output captured
(``flax.linen.intercept_methods``) and the int8 operands of its
``conv_general_dilated`` recorded.  The port's ``ConvBN`` then runs on
JAX's own input to each conv: its ``x8`` and ``w8`` must equal JAX's
exactly, and its output JAX's within f32 rounding (1e-6 of the output's
largest magnitude, about 8 ulps: BatchNorm is PyTorch's, whose f32 order
differs from Flax's), or in bf16 within one bf16 ulp of each value (that
f32 difference can land a bf16 rounding one ulp apart).  Every stem, f32
and bf16; the trunk's stride-2 convs (the 7x7 stem, the strided 3x3s,
the projections) are among them.

Each trunk also runs on its own, port and JAX, and the conv inputs'
quantized values that differ are counted, conv by conv (printed).  None
differs on equal inputs, so every difference is a cascade: an f32
BatchNorm output one ulp apart lands on the other side of a
quantization step now and then (a seed), and the step reaches the next
conv's every output that reads it, some of which then cross steps too.
On this clip the s2d stem in f32 has one seed (at block 0's 3x3), which
grows to 1,024 of the 8,192 values of the last 3x3's input, and
``s2d_pre`` in bf16 one that grows to 72 of 8,192; the other four
configurations have none.  ``tests/test_torch_port_int8_pipeline.py``
states the rule on the whole pipeline that follows.  (JAX's jitted
trunk has a second source of such cascades, which op by op it has not:
XLA computes the quantizer's ``max / 127.0`` as ``max * (1 / 127)``.)

Also here: the plain int8 conv against a float64 numpy convolution,
exactly, at every kernel size, stride and padding the trunk uses and at
ragged ones; and the quantizers on a whole batch (one scale) and with a
static ``act_scale``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from torch_port_fixtures import (
    jax_pipeline,
    one_torch_thread,
    save_npz,
    torch_pipeline,
)

STEMS = ("classic", "s2d", "s2d_pre")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
T, S = 4, 64

_one_thread = pytest.fixture(autouse=True, scope="module")(
    one_torch_thread)


def clip_for(stem, seed=3):
    """A normalized-looking clip in the stem's layout."""
    rs = np.random.RandomState(seed)
    if stem == "s2d_pre":
        return rs.randn(T, S // 4, S // 4, 48).astype(np.float32)
    return rs.randn(T, S, S, 3).astype(np.float32)


def f32(a):
    return np.array(jnp.asarray(a, jnp.float32))


def jax_trunk_record(pipe, variables, clip, monkeypatch, convs=None):
    """JAX's int8 trunk op by op: ``{module path: (input, output)}`` of
    every ``ConvBN`` in call order, and the ``(x8, w8)`` of its int8
    ``conv_general_dilated`` calls in the same order; given a list
    ``convs``, the output of each ``_int8_conv`` call (the dequantized
    conv, before BatchNorm) appended to it in the same order."""
    from tao_amodal_tpu.models import backbones as jb

    det = pipe.detector
    trunk = jb.ResNet(stage_sizes=det.backbone_stages, out_stages=(2, 3, 4),
                      dtype=det.dtype, int8=True, stem=det.stem)
    tv = {c: variables["detector"][c]["backbone"]
          for c in ("params", "batch_stats")}
    calls, operands = {}, []
    conv = jax.lax.conv_general_dilated

    def record(lhs, rhs, *args, **kwargs):
        if lhs.dtype == jnp.int8:
            operands.append((np.array(lhs), np.array(rhs)))
        return conv(lhs, rhs, *args, **kwargs)

    def intercept(next_fun, args, kwargs, ctx):
        out = next_fun(*args, **kwargs)
        if isinstance(ctx.module, jb.ConvBN) and ctx.method_name == "__call__":
            calls[ctx.module.path] = (f32(args[0]), f32(out))
        return out

    monkeypatch.setattr(jax.lax, "conv_general_dilated", record)
    if convs is not None:
        body = jb._int8_conv

        def int8_conv_out(*args, **kwargs):
            out = body(*args, **kwargs)
            convs.append(f32(out))
            return out

        monkeypatch.setattr(jb, "_int8_conv", int8_conv_out)
    with nn.intercept_methods(intercept):
        outs = trunk.apply(tv, jnp.asarray(clip).astype(det.dtype))
    monkeypatch.undo()
    return calls, operands, [f32(o) for o in outs]


def port_trunk_inputs(backbone, clip, dtype):
    """The port's trunk on its own: ``{module path: input NHWC f32}`` of
    every ``ConvBN``."""
    seen, hooks = {}, []
    for name, m in backbone.named_modules():
        if type(m).__name__ == "ConvBN":
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a, key=tuple(name.split(".")): seen.__setitem__(
                    key, a[0].float().permute(0, 2, 3, 1).numpy().copy())))
    try:
        with torch.no_grad():
            backbone(torch.from_numpy(clip).to(dtype).permute(0, 3, 1, 2))
    finally:
        for h in hooks:
            h.remove()
    return seen


def module_at(root, path):
    for p in path:
        root = getattr(root, p)
    return root


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("stem", STEMS)
def test_int8_convbn_on_equal_inputs_matches_jax(stem, dt, tmp_path,
                                                 monkeypatch):
    """Every ``ConvBN`` of the TINY int8 trunk on JAX's own input to it:
    x8 and w8 exact, the output within f32 rounding (bf16: one ulp), and
    ``quantized_conv``'s plain path (the body the ``ConvBN`` runs, on its
    NCHW input) equal to JAX's ``_int8_conv`` output bit for bit: the
    same exact integer sums, dequantized in the same f32 order.  Then the
    cascade count of the two trunks run on their own."""
    from tao_amodal_torch.ops import int8_conv

    jdt, tdt = DTYPES[dt]
    pipe, variables = jax_pipeline(seed=1, int8_backbone=True, stem=stem,
                                   dtype=jdt)
    tp = torch_pipeline(save_npz(tmp_path, variables), int8_backbone=True,
                        stem=stem, dtype=tdt)
    clip = clip_for(stem)
    convs = []
    calls, operands, _ = jax_trunk_record(pipe, variables, clip, monkeypatch,
                                          convs)
    assert len(calls) == len(operands) == len(convs) == 17  # stem, 4 x 4
    strided = 0
    for (path, (x, want)), (jx8, jw8), jconv in zip(calls.items(), operands,
                                                    convs):
        cb = module_at(tp.detector.backbone, path)
        w8, s_w = cb.quantized()
        np.testing.assert_array_equal(w8.numpy(), jw8, err_msg=str(path))
        xt = torch.from_numpy(x).to(tdt)
        x8, _ = int8_conv.quantize_activation(xt)
        np.testing.assert_array_equal(x8.numpy(), jx8, err_msg=str(path))
        qc = int8_conv.quantized_conv(xt.permute(0, 3, 1, 2), w8, s_w,
                                      cb.strides, cb.pad, tdt, cb.act_scale)
        assert qc.dtype == tdt
        np.testing.assert_array_equal(qc.permute(0, 2, 3, 1).float().numpy(),
                                      jconv, err_msg=str(path))
        with torch.no_grad():
            got = cb(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert got.dtype == tdt
        got = got.float().numpy()
        assert got.shape == want.shape, (path, got.shape, want.shape)
        d = np.abs(got - want)
        if dt == "f32":
            assert d.max() <= 1e-6 * np.abs(want).max(), (path, d.max())
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                       1e-30))) - 7)
            assert (d <= ulp).all(), (path, (d / ulp).max())
        strided += cb.strides == 2
    # Stages 2-4: the first block's 3x3 and projection; and the 7x7 stem.
    assert strided == (7 if stem == "classic" else 6)

    # The cascade: each trunk on its own, quantized inputs compared.
    seen = port_trunk_inputs(tp.detector.backbone, clip, tdt)
    counts = []
    for path, (x, _) in calls.items():
        a, _ = int8_conv.quantize_activation(torch.from_numpy(x))
        b, _ = int8_conv.quantize_activation(torch.from_numpy(seen[path]))
        counts.append(int((a != b).sum()))
    print(f"{stem} {dt}: quantized inputs that differ, conv by conv: "
          f"{counts} of {[v[0].size for v in calls.values()]}")
    assert counts[0] == 0  # the clip itself


@pytest.mark.parametrize("ks,stride,hw,cin,cout", [
    (7, 2, (19, 22), 3, 16),     # the classic stem, odd frame
    (3, 1, (9, 7), 48, 32),      # the s2d stems
    (3, 2, (10, 11), 32, 16),    # a strided 3x3
    (1, 2, (9, 9), 16, 48),      # a projection, odd frame
    (1, 1, (5, 6), 64, 16),
])
def test_plain_int8_conv_equals_float64_numpy(ks, stride, hw, cin, cout):
    """``int8_conv`` on CPU tensors (the plain version) against a direct
    float64 numpy convolution of the same int8 operands and the same
    f32 scale: bit for bit, in f32 and bf16 out."""
    from tao_amodal_torch.ops import int8_conv

    rs = np.random.RandomState(ks * 10 + stride)
    x8 = rs.randint(-127, 128, (2, *hw, cin)).astype(np.int8)
    w8 = rs.randint(-127, 128, (ks, ks, cin, cout)).astype(np.int8)
    scale = rs.uniform(1e-5, 1e-3, cout).astype(np.float32)
    pad = (ks - 1) // 2
    xp = np.pad(x8.astype(np.float64),
                ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    Ho = (hw[0] + 2 * pad - ks) // stride + 1
    Wo = (hw[1] + 2 * pad - ks) // stride + 1
    acc = np.zeros((2, Ho, Wo, cout))
    for ky in range(ks):
        for kx in range(ks):
            win = xp[:, ky:ky + stride * (Ho - 1) + 1:stride,
                     kx:kx + stride * (Wo - 1) + 1:stride]
            acc += win @ w8[ky, kx].astype(np.float64)
    want = acc.astype(np.float32) * scale
    for out_dtype in (torch.float32, torch.bfloat16):
        got = int8_conv.int8_conv(torch.from_numpy(x8), torch.from_numpy(w8),
                                  torch.from_numpy(scale), stride, pad,
                                  out_dtype)
        assert got.dtype == out_dtype and got.shape == want.shape
        np.testing.assert_array_equal(
            got.float().numpy(),
            torch.from_numpy(want).to(out_dtype).float().numpy())


def test_quantizers_one_scale_per_batch_and_static_scale():
    """``s_x`` is the abs-max over every frame of the batch (a frame
    alone gets another scale), a static ``act_scale`` replaces it (and
    clips), and the weights' scales are per output channel."""
    from tao_amodal_torch.ops import int8_conv

    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(3, 4, 5, 8).astype(np.float32))
    x[2] *= 4
    x8, s = int8_conv.quantize_activation(x)
    assert s.dim() == 0 and float(s) == float(x.abs().max() / 127.0)
    x8_0, s0 = int8_conv.quantize_activation(x[:1])
    assert float(s0) < float(s) and not torch.equal(x8_0, x8[:1])
    st8, st = int8_conv.quantize_activation(x, act_scale=0.01)
    assert float(st) == np.float32(0.01)
    assert int(st8.max()) == 127 and int(st8.min()) == -127
    w = torch.from_numpy(rs.randn(3, 3, 8, 4).astype(np.float32))
    w8, s_w = int8_conv.quantize_weight(w)
    assert s_w.shape == (4,)
    assert (w8.abs().amax(dim=(0, 1, 2)) == 127).all()
