"""How well conditioned Siamese training's and the DiMP actor's f32
gradients are, measured outside the tests (the numbers behind the bounds
of ``tests/test_torch_port_{sot_train,dimp_train}.py`` and the SOTTRAIN
and DIMP_TINY constants of ``chip_smoke.py``).  CPU only; imports the JAX
package, as the tests do.

    JAX_PLATFORMS=cpu python experiments/sot_train_conditioning.py siamese
    JAX_PLATFORMS=cpu python experiments/sot_train_conditioning.py dimp
    JAX_PLATFORMS=cpu python experiments/sot_train_conditioning.py dimp_cls
    JAX_PLATFORMS=cpu python experiments/sot_train_conditioning.py solve

- ``siamese``: one ``build_siamese_training`` step's gradients at the
  train CLI's ``--smoke`` crops (64/128) on the step test's bridged
  weights, batch and key: JAX f32 (jitted) and the port against JAX in
  float64 (``jax.enable_x64``) on the same targets, each leaf's max |d|
  over the oracle's largest: the worst and the median leaf.
- ``dimp``: the actor of ``tests/test_optimization.py``'s size: how far a
  one-ulp change of the train images (times 1 + 2^-23) moves the
  response term and the extractor's meta-gradient, in each package, and
  how far the port is from JAX.
- ``dimp_cls``: the same actor's response term alone (the extractor, the
  2 x 3 Gauss-Newton/CG solve, the test frames' responses) and its
  gradient in the extractor's kernel: JAX f32 and the port in f32 against
  the port in float64 (JAX's correlation fixes f32 accumulation), and the
  port with only the solve in float64.
- ``solve``: the 2 x 3 filter solve alone on seeded ReLU features (2
  train and 2 test maps of 8 x 8 x 16, a 3 x 3 filter): the gradient of
  the test responses' error in the train features, JAX f32 and the port
  in f32 against the port in float64, and each one's move under a
  one-ulp change of the features.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def siamese():
    import test_torch_port_sot_train as t

    step = t.siamese_step.__wrapped__()
    names = sorted(step["grads64"])
    port_step, _ = t._port_step(step["flat"])
    draws = t._jax_anchor_draws(step["rng"], 2, len(step["anchors"]))
    loss, _, grads = port_step.loss_and_grads(step["batch"], draws)
    port = t._grad_errors(port_step.flax_names(), grads, step["grads64"])
    jax32 = t._grad_errors(names, [step["grads"][n] for n in names],
                           step["grads64"])
    for name, errs in (("JAX f32", jax32), ("port f32", port)):
        worst = max(errs, key=errs.get)
        print(f"{name} against float64 JAX over {len(errs)} leaves: worst "
              f"{errs[worst]:.3e} ({worst}), median "
              f"{np.median(list(errs.values())):.3e}")
    print(f"loss: JAX f32 {float(step['loss']):.9g}, port {float(loss):.9g}")


def dimp():
    import test_torch_port_dimp_train as t

    variables, jruns = t.jax_actor.__wrapped__()
    pruns = [t._port_run(variables, s) for s in t.ULP_SCALES]
    kernel = "extractor/params/Conv_0/kernel"
    for name, runs in (("JAX", jruns), ("port", pruns)):
        cls = t._spread(runs, "dimp_cls") / abs(runs[0]["dimp_cls"])
        g = t._spread(runs, "grads", kernel) / np.abs(
            runs[0]["grads"][kernel]).max()
        print(f"{name}: a one-ulp change of the images moves dimp_cls by "
              f"{cls:.2e} relative and the extractor kernel's gradient by "
              f"{g:.2e} of its largest")
    d = abs(pruns[0]["dimp_cls"] - jruns[0]["dimp_cls"]) / abs(
        jruns[0]["dimp_cls"])
    w = jruns[0]["grads"][kernel]
    g = np.abs(pruns[0]["grads"][kernel] - w).max() / np.abs(w).max()
    print(f"port against JAX: dimp_cls {d:.2e} relative, the extractor "
          f"kernel's gradient {g:.2e} of its largest")


def dimp_cls():
    import test_torch_port_dimp_train as t
    from tao_amodal_torch.models.dimp import classify, train_filter
    from tao_amodal_torch.train.dimp_loss import response_targets
    from tao_amodal_tpu.models.dimp import classify as jclassify
    from tao_amodal_tpu.models.dimp import train_filter as jtrain_filter
    from tao_amodal_tpu.train.dimp_loss import (
        response_targets as jresponse_targets,
    )

    variables, _ = t.jax_actor.__wrapped__()
    b = t._batch()
    conv = variables["extractor"]["params"]["Conv_0"]
    kern, bias = np.asarray(conv["kernel"]), np.asarray(conv["bias"])

    def labels(i, key, fn, xp):
        return fn(xp.asarray(b[key][i]), 8, 6, (32, 32))

    def port(dt, solve_dt):
        w = torch.tensor(kern.transpose(3, 2, 0, 1).copy(), dtype=dt,
                         requires_grad=True)
        bb = torch.tensor(bias, dtype=dt)

        def ext(im):
            x = torch.nn.functional.conv2d(
                torch.tensor(im, dtype=dt).permute(0, 3, 1, 2), w, bb,
                stride=4)
            return torch.relu(x).permute(0, 2, 3, 1).to(solve_dt)

        total = 0
        for i in range(2):
            f, _ = train_filter(ext(b["train_images"][i]), labels(
                i, "train_boxes", response_targets, torch).to(solve_dt),
                (3, 3, 16), num_gn_iters=2, num_cg_iters=3)
            resp = classify(ext(b["test_images"][i]), f)
            total = total + torch.mean((resp - labels(
                i, "test_boxes", response_targets, torch)) ** 2)
        (g,) = torch.autograd.grad(total / 2, [w])
        return float(total / 2), g.double().numpy().transpose(2, 3, 1, 0)

    def jax_loss(k):
        def ext(im):
            x = jax.lax.conv_general_dilated(
                jnp.asarray(im), k, (4, 4), "VALID",
                dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
            return jax.nn.relu(x)

        total = 0
        for i in range(2):
            f, _ = jtrain_filter(ext(b["train_images"][i]), labels(
                i, "train_boxes", jresponse_targets, jnp), (3, 3, 16),
                num_gn_iters=2, num_cg_iters=3)
            resp = jclassify(ext(b["test_images"][i]), f)
            total = total + jnp.mean((resp - labels(
                i, "test_boxes", jresponse_targets, jnp)) ** 2)
        return total / 2

    l64, g64 = port(torch.float64, torch.float64)
    scale = np.abs(g64).max()
    jl, jg = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(kern))
    rows = [("JAX f32", float(jl), np.asarray(jg, np.float64)),
            ("port f32", *port(torch.float32, torch.float32)),
            ("port f32, the solve in float64",
             *port(torch.float32, torch.float64))]
    print(f"float64 (port): response term {l64:.10g}")
    for name, loss, g in rows:
        print(f"{name}: response term {abs(loss - l64) / l64:.2e} relative "
              f"off float64, the kernel's gradient "
              f"{np.abs(g - g64).max() / scale:.2e} of its largest")


def solve():
    from tao_amodal_torch.models.dimp import classify, train_filter
    from tao_amodal_tpu.models.dimp import classify as jclassify
    from tao_amodal_tpu.models.dimp import train_filter as jtrain_filter

    rs = np.random.RandomState(0)
    tr = np.maximum(rs.randn(2, 8, 8, 16), 0).astype(np.float32)
    te = np.maximum(rs.randn(2, 8, 8, 16), 0).astype(np.float32)
    lab, want = (rs.rand(2, 6, 6).astype(np.float32) for _ in range(2))
    ulp = np.float32(1 + 2 ** -23)

    def port(dt, feats):
        t = torch.tensor(feats, dtype=dt, requires_grad=True)
        f, _ = train_filter(t, torch.tensor(lab, dtype=dt), (3, 3, 16),
                            num_gn_iters=2, num_cg_iters=3)
        err = torch.mean((classify(torch.tensor(te, dtype=dt), f)
                          - torch.tensor(want, dtype=dt)) ** 2)
        (g,) = torch.autograd.grad(err, [t])
        return g.double().numpy()

    def jax_err(t):
        f, _ = jtrain_filter(t, jnp.asarray(lab), (3, 3, 16),
                             num_gn_iters=2, num_cg_iters=3)
        return jnp.mean((jclassify(jnp.asarray(te), f)
                         - jnp.asarray(want)) ** 2)

    jgrad = jax.jit(jax.grad(jax_err))
    g64 = port(torch.float64, tr)
    scale = np.abs(g64).max()
    for name, fn in (("JAX f32", lambda x: np.asarray(jgrad(
            jnp.asarray(x)), np.float64)),
            ("port f32", lambda x: port(torch.float32, x))):
        g, moved = fn(tr), fn(tr * ulp)
        print(f"{name}: {np.abs(g - g64).max() / scale:.2e} of the largest "
              f"off float64; a one-ulp change of the features moves it "
              f"{np.abs(moved - g).max() / scale:.2e}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    {"siamese": siamese, "dimp": dimp, "dimp_cls": dimp_cls,
     "solve": solve}[sys.argv[1]]()
