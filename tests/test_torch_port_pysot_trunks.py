"""The pysot trunks of the port (``AlexNet``, ``InvertedResidual``,
``MobileNetV2`` in ``tao_amodal_torch/models/backbones.py``) held
against the JAX package's on the CPU.

Weights come from the JAX modules' own init, with every BatchNorm
statistic, scale and bias perturbed (``torch_port_fixtures.perturb``),
carried across by ``utils/weights.py::load_variables`` and back by
``flat_variables``.  Each trunk runs with ``train`` False (running
statistics) and True (the batch's statistics; the running ones move as
JAX's ``batch_stats`` do, which are compared too).

Tolerances.  f32: within 1e-4 of the largest |output|.  bf16: every
layer (AlexNet's conv and BatchNorm, MobileNetV2's stem and each
inverted residual) on JAX's own input to it, within B8's rule
(``tests/test_torch_port_bf16_modules.py::assert_close``).  The whole
trunk's outputs: within the same rule, or, where the chain carries the
layers' rare one-ulp flips into most outputs, no less accurate than
JAX's own bf16 trunk: the max and the mean of |port bf16 - JAX f32| at
most 1.25 times those of |JAX bf16 - JAX f32|.  The flips come from the
sums: the port's CPU rounds each conv's exact sum (f64) and JAX's sums
in f32; in training mode JAX's f32 ``E[x^2] - E[x]^2`` also loses about
1e-4 of a variance where the mean is several times the spread, and the
batch statistics pass such shifts on to every output.  JAX is jitted
with XLA's excess precision off, which keeps every bf16 rounding.  The
cases run at one torch thread (``one_torch_thread``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from test_torch_port_bf16_modules import NO_EXCESS, assert_close, f32
from torch_port_fixtures import one_torch_thread, perturb

F32_RTOL = 1e-4
# bf16 trunk against JAX's own bf16 error from f32 (module docstring).
ACCURACY_FACTOR = 1.25

# (name, JAX kwargs, input side, batch); the MobileNetV2 cases run from
# tests/test_torch_port_mobilenet.py, on another test worker.
CASES = {
    "alexnet_127": ("AlexNet", dict(width_mult=1.0), 127, 2),
    "alexnet_255": ("AlexNet", dict(width_mult=1.0), 255, 1),
    "alexnet_127_half": ("AlexNet", dict(width_mult=0.5), 127, 2),
    "alexnet_255_half": ("AlexNet", dict(width_mult=0.5), 255, 1),
    "mobilenet_357_255": ("MobileNetV2", dict(out_stages=(3, 5, 7)), 255, 1),
    "mobilenet_7_64": ("MobileNetV2", dict(out_stages=(7,)), 64, 2),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    yield from one_torch_thread()


def flat(variables):
    """JAX variables -> ``{"params/...": f32 ndarray}``."""
    return {"/".join((col, *path)): np.asarray(leaf, np.float32)
            for col, tree in variables.items()
            for path, leaf in traverse_util.flatten_dict(
                dict(tree)).items()}


def as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def jax_case(name, dtype, seed=0):
    """The JAX module in ``dtype``, its perturbed variables and an NHWC
    input (the variables are f32 whatever the dtype: one init a case and
    seed)."""
    from tao_amodal_tpu.models import backbones as jb

    cls, kw, _, _ = CASES[name]
    v, x = _variables(name, seed)
    return getattr(jb, cls)(dtype=dtype, **kw), v, x


@functools.lru_cache(maxsize=None)
def _variables(name, seed):
    from tao_amodal_tpu.models import backbones as jb

    cls, kw, side, batch = CASES[name]
    rs = np.random.RandomState(seed)
    x = jnp.asarray(rs.randn(batch, side, side, 3).astype(np.float32))
    init = jax.jit(getattr(jb, cls)(**kw).init)
    return perturb(init(jax.random.PRNGKey(seed), x), rs), x


def port_model(name, dtype, variables):
    from tao_amodal_torch.models import backbones as tb
    from tao_amodal_torch.utils.weights import load_variables

    cls, kw, _, _ = CASES[name]
    m = getattr(tb, cls)(dtype=dtype, device="cpu", **kw)
    load_variables(m, flat(variables))
    return m.eval()


def run_port(m, x, train):
    with torch.no_grad():
        out = m(torch.from_numpy(f32(x).copy()).permute(0, 3, 1, 2),
                train=train)
    return [o.permute(0, 2, 3, 1) for o in as_list(out)]


def run_jax(jm, v, x, train, intermediates=False):
    """JAX's outputs (a list), its moved ``batch_stats`` (flat, with
    ``train``) and its captured intermediates (with ``intermediates``),
    jitted with XLA's excess precision off."""
    mutable = (["batch_stats"] if train else []) + (
        ["intermediates"] if intermediates else [])
    fn = jax.jit(functools.partial(
        jm.apply, train=train, mutable=mutable or False,
        capture_intermediates=intermediates), compiler_options=NO_EXCESS)
    if not mutable:
        return as_list(fn(v, x)), None, None
    out, state = fn(v, x)
    stats = {k: v for k, v in state.items() if k == "batch_stats"}
    return (as_list(out), flat(stats) if train else None,
            state.get("intermediates"))


def t_nchw(a, dtype=torch.bfloat16):
    """A JAX NHWC array as an NCHW tensor of ``dtype``."""
    return torch.from_numpy(f32(a).copy()).permute(0, 3, 1, 2).to(dtype)


def layer_pairs(m, x, inter, train):
    """``(what, port output NHWC, JAX output)`` of every layer of the
    trunk, each fed JAX's own input to that layer."""
    import torch.nn.functional as F

    from tao_amodal_torch.models import layers

    def out(key):
        return inter[key]["__call__"][0]

    def nhwc(t):
        return t.permute(0, 2, 3, 1)

    if hasattr(m, "Conv_4"):                          # AlexNet
        h = t_nchw(x, torch.float32)
        for i in range(5):
            conv, bn = getattr(m, f"Conv_{i}"), getattr(m, f"BatchNorm_{i}")
            yield (f"Conv_{i}", nhwc(layers.conv(h, conv, m.dtype)),
                   out(f"Conv_{i}"))
            y = t_nchw(out(f"Conv_{i}"))
            z = (layers.batch_norm_train(y, bn, m.dtype, 0.99) if train
                 else layers.batch_norm(y, bn, m.dtype))
            yield f"BatchNorm_{i}", nhwc(z), out(f"BatchNorm_{i}")
            h = t_nchw(out(f"BatchNorm_{i}"))
            if i < 4:
                h = F.relu(h)
            if i < 2:
                h = F.max_pool2d(h, 3, stride=2)
        return
    h = out("ConvBN_0")                                # MobileNetV2
    yield ("ConvBN_0", nhwc(m.ConvBN_0(t_nchw(x, torch.float32),
                                       train=train)), h)
    block = 0
    while f"InvertedResidual_{block}" in inter:
        key = f"InvertedResidual_{block}"
        yield key, nhwc(getattr(m, key)(t_nchw(h), train)), out(key)
        h = out(key)
        block += 1


ALEXNET = [n for n in CASES if n.startswith("alexnet")]
MOBILENET = [n for n in CASES if n.startswith("mobilenet")]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ALEXNET)
def test_trunk_f32_matches_jax(name, train):
    check_f32(name, train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ALEXNET)
def test_trunk_bf16_matches_jax(name, train):
    check_bf16(name, train)


def check_f32(name, train):
    """f32, TF32 irrelevant on the CPU: every output within 1e-4 of its
    largest |value|, and with ``train`` the moved running statistics
    within 1e-5 of their largest."""
    jm, v, x = jax_case(name, jnp.float32)
    want, upd, _ = run_jax(jm, v, x, train)
    m = port_model(name, torch.float32, v)
    got = run_port(m, x, train)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = f32(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        d = np.abs(g.numpy() - w).max()
        assert d <= F32_RTOL * np.abs(w).max(), (name, i, d)
    if train:
        from tao_amodal_torch.utils.weights import flat_variables

        moved = flat_variables(m)
        for key, want_stat in upd.items():
            got_stat = moved[key]
            d = np.abs(got_stat - want_stat).max()
            assert d <= 1e-5 * max(np.abs(want_stat).max(), 1.0), (key, d)


def check_bf16(name, train):
    """bf16 at Flax's rounding points: every layer on JAX's own input
    within B8's rule; the trunk's outputs within the rule, or no less
    accurate against JAX's f32 trunk than JAX's own bf16 trunk (module
    docstring); JAX's output dtype."""
    from tao_amodal_tpu.models import backbones as jb

    jm, v, x = jax_case(name, jnp.bfloat16, seed=1)
    want, _, inter = run_jax(jm, v, x, train, intermediates=True)
    m = port_model(name, torch.bfloat16, v)
    with torch.no_grad():
        pairs = list(layer_pairs(m, x, inter, train))
        assert len(pairs) == (10 if name.startswith("alexnet") else 18)
        for what, g, w in pairs:
            assert_close(g, w, f"{name} {what}")
    got = run_port(port_model(name, torch.bfloat16, v), x, train)
    assert len(got) == len(want)
    exact = None
    for i, (g, w) in enumerate(zip(got, want)):
        try:
            assert_close(g, w, f"{name} output {i}")
            continue
        except AssertionError:
            pass
        if exact is None:
            cls, kw, _, _ = CASES[name]
            exact, _, _ = run_jax(getattr(jb, cls)(**kw), v, x, train)
        t = f32(exact[i])
        ours, theirs = np.abs(g.float().numpy() - t), np.abs(f32(w) - t)
        for stat in (np.max, np.mean):
            assert stat(ours) <= ACCURACY_FACTOR * stat(theirs), (
                name, i, stat.__name__, stat(ours), stat(theirs))


@pytest.mark.parametrize("name", ["alexnet_127_half"])
def test_flat_variables_round_trip(name):
    check_round_trip(name)


def check_round_trip(name):
    """``flat_variables`` gives back JAX's variables tree exactly, key for
    key, layout for layout (the depthwise kernel ``[3, 3, 1, C]``
    included)."""
    from tao_amodal_torch.utils.weights import flat_variables

    jm, v, _ = jax_case(name, jnp.float32)
    want = flat(v)
    got = flat_variables(port_model(name, torch.float32, v))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if name.startswith("mobilenet"):
        dw = "params/InvertedResidual_1/Conv_0/kernel"
        assert got[dw].shape[2] == 1 and got[dw].shape[:2] == (3, 3)


def test_inverted_residual_matches_jax():
    """One block of each kind: expand 6 with the residual (stride 1, equal
    widths), and a strided, dilated block without it."""
    from tao_amodal_tpu.models.backbones import InvertedResidual as JIR
    from tao_amodal_torch.models.backbones import InvertedResidual
    from tao_amodal_torch.utils.weights import load_variables

    rs = np.random.RandomState(5)
    for kw, cin in ((dict(features=16, strides=1, expand=6), 16),
                    (dict(features=24, strides=2, expand=6, dilation=2), 16),
                    (dict(features=8, strides=1, expand=1), 16)):
        x = jnp.asarray(rs.randn(2, 17, 17, cin).astype(np.float32))
        jm = JIR(**kw)
        v = perturb(jm.init(jax.random.PRNGKey(5), x), rs)
        m = InvertedResidual(cin, device="cpu", **kw)
        load_variables(m, flat(v))
        assert m.residual == (kw["strides"] == 1 and cin == kw["features"])
        for train in (False, True):
            want = f32(run_jax(jm, v, x, train)[0][0])
            got = run_port(m.eval(), x, train)[0].numpy()
            assert np.abs(got - want).max() <= F32_RTOL * np.abs(want).max()
