"""How well conditioned Siamese training's and the DiMP actor's f32
gradients are, measured outside the tests (the numbers behind the bounds
of ``tests/test_torch_port_{sot_train,dimp_train}.py`` and the SOTTRAIN
and DIMP_TINY constants of ``chip_smoke.py``).  CPU only; imports the JAX
package, as the tests do.

    JAX_PLATFORMS=cpu python experiments/sot_train_conditioning.py siamese
    JAX_PLATFORMS=cpu python experiments/sot_train_conditioning.py dimp
    JAX_PLATFORMS=cpu python experiments/sot_train_conditioning.py dimp_cls
    JAX_PLATFORMS=cpu python experiments/sot_train_conditioning.py ops
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
  gradient in the extractor's kernel, against a float64 oracle (JAX's
  solver under ``jax.enable_x64``, its correlations in float64): JAX
  f32, the port in f32, and the float64 oracle itself, each off the
  oracle and moved by a one-ulp change of the train images.  (The port
  in float64 is no oracle: its ``ops/xcorr.py`` sums its correlations in
  f32 whatever the input.)
- ``ops``: the solve op by op: every CG step's ``pAp``, ``alpha`` and
  ``rho`` of both sequences' two Gauss-Newton steps, JAX f32 and the
  port f32 on the same (bit-equal) features, each against the float64
  oracle, and where each first leaves it by more than 1e-4.
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


# A one-ulp change of f32 images (times 1 + 2^-23).
ULP = np.float32(1 + 2 ** -23)


def _actor_setup():
    """The actor test's extractor weights, batch and f32 response
    targets (label maps computed once, by JAX)."""
    import test_torch_port_dimp_train as t
    from tao_amodal_tpu.train.dimp_loss import response_targets

    variables, _ = t.jax_actor.__wrapped__()
    b = t._batch()
    conv = variables["extractor"]["params"]["Conv_0"]
    labels = {(i, key): np.asarray(response_targets(
        jnp.asarray(b[key][i]), 8, 6, (32, 32)))
        for i in range(2) for key in ("train_boxes", "test_boxes")}
    return (np.asarray(conv["kernel"]), np.asarray(conv["bias"]), b,
            labels)


def _jax_features(kern, bias, im, dt):
    x = jax.lax.conv_general_dilated(
        jnp.asarray(im, dt), jnp.asarray(kern, dt), (4, 4), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + jnp.asarray(bias, dt)
    return jax.nn.relu(x)


def _classify64(f, filt):
    """JAX's ``classify`` (a depthwise correlation summed over channels)
    without its f32 ``preferred_element_type``: float64 under x64."""
    fh, fw, C = filt.shape
    B = f.shape[0]
    out = jax.lax.conv_general_dilated(
        f.transpose(1, 2, 0, 3).reshape(1, f.shape[1], f.shape[2], -1),
        jnp.broadcast_to(filt, (B, fh, fw, C)).transpose(
            1, 2, 0, 3).reshape(fh, fw, 1, -1),
        (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=B * C)
    ho, wo = out.shape[1:3]
    return out.reshape(ho, wo, B, C).transpose(2, 0, 1, 3).sum(-1)


def _oracle_residual(feats, lab, dt):
    def residual(filt):
        return {"data": _classify64(feats, filt) - jnp.asarray(lab, dt),
                "reg": jnp.sqrt(jnp.asarray(1e-2, dt)) * filt}
    return residual


def dimp_cls():
    from tao_amodal_torch.models.dimp import classify, train_filter
    from tao_amodal_tpu.models.dimp import classify as jclassify
    from tao_amodal_tpu.models.dimp import train_filter as jtrain_filter
    from tao_amodal_tpu.ops.optimization import gauss_newton_cg

    kern, bias, b, lab = _actor_setup()

    def port(images):
        w = torch.tensor(kern.transpose(3, 2, 0, 1).copy(),
                         requires_grad=True)

        def ext(im):
            x = torch.nn.functional.conv2d(
                torch.tensor(im).permute(0, 3, 1, 2), w,
                torch.tensor(bias), stride=4)
            return torch.relu(x).permute(0, 2, 3, 1)

        total = 0
        for i in range(2):
            f, _ = train_filter(ext(images[i]), torch.tensor(
                lab[i, "train_boxes"]), (3, 3, 16), num_gn_iters=2,
                num_cg_iters=3)
            resp = classify(ext(b["test_images"][i]), f)
            total = total + torch.mean((resp - torch.tensor(
                lab[i, "test_boxes"])) ** 2)
        (g,) = torch.autograd.grad(total / 2, [w])
        return float(total / 2), g.double().numpy().transpose(2, 3, 1, 0)

    def jax_loss(k, images, dt):
        total = 0
        for i in range(2):
            feats = _jax_features(k, bias, images[i], dt)
            te = _jax_features(k, bias, b["test_images"][i], dt)
            if dt == jnp.float32:
                f, _ = jtrain_filter(feats, jnp.asarray(
                    lab[i, "train_boxes"]), (3, 3, 16), num_gn_iters=2,
                    num_cg_iters=3)
                resp = jclassify(te, f)
            else:
                f, _ = gauss_newton_cg(
                    _oracle_residual(feats, lab[i, "train_boxes"], dt),
                    jnp.zeros((3, 3, 16), dt), 2, 3)
                resp = _classify64(te, f)
            total = total + jnp.mean((resp - jnp.asarray(
                lab[i, "test_boxes"], dt)) ** 2)
        return total / 2

    def jax_run(dt):
        fn = jax.jit(jax.value_and_grad(lambda k, im: jax_loss(k, im, dt)))

        def run(images):
            loss, g = fn(jnp.asarray(kern, dt), jnp.asarray(images, dt))
            return float(loss), np.asarray(g, np.float64)
        return run

    images = b["train_images"]
    with jax.enable_x64():
        oracle = jax_run(jnp.float64)
        l64, g64 = oracle(images.astype(np.float64))
        rows = [("float64 oracle", oracle(images.astype(np.float64)),
                 oracle((images * ULP).astype(np.float64)))]
    jax32 = jax_run(jnp.float32)
    rows += [("JAX f32", jax32(images), jax32(images * ULP)),
             ("port f32", port(images), port(images * ULP))]
    scale = np.abs(g64).max()
    print(f"float64 oracle (JAX x64): response term {l64:.10g}")
    for name, (loss, g), (_, moved) in rows:
        print(f"{name}: response term {abs(loss - l64) / l64:.2e} relative "
              f"off float64, the kernel's gradient "
              f"{np.abs(g - g64).max() / scale:.2e} of its largest off "
              f"float64; a one-ulp change of the images moves the gradient "
              f"{np.abs(moved - g).max() / scale:.2e}")


def ops():
    from torch.func import jvp, vjp

    from tao_amodal_torch.models.dimp import classify
    from tao_amodal_tpu.models.dimp import classify as jclassify

    kern, bias, b, lab = _actor_setup()

    def cg_trace(residual, p, vjp_fn_of, jdx_of, dot, zeros):
        """Two Gauss-Newton steps of three CG steps, written out as both
        packages' solvers run them: (pAp, alpha, rho) a CG step."""
        out = []
        for _ in range(2):
            r0, vjp_fn = vjp_fn_of(residual, p)
            A = jdx_of(residual, p, vjp_fn)
            bb = -vjp_fn(r0)[0]
            x, r, d, rho = zeros(bb), bb, bb, dot(bb, bb)
            for _ in range(3):
                Ad = A(d)
                pAp = dot(d, Ad)
                alpha = rho / pAp
                x, r = x + alpha * d, r - alpha * Ad
                rho_new = dot(r, r)
                d = r + rho_new / rho * d
                rho = rho_new
                out.append([float(pAp), float(alpha), float(rho)])
            p = p + x
        return np.asarray(out)

    def jax_trace(feats, lab_i, dt):
        if dt == jnp.float32:
            def residual(filt):
                return {"data": jclassify(feats, filt) - lab_i,
                        "reg": jnp.sqrt(1e-2) * filt}
        else:
            residual = _oracle_residual(feats, lab_i, dt)

        def jdx_of(res, p, vjp_fn):
            _, lin = jax.linearize(res, p)
            return lambda dx: vjp_fn(lin(dx))[0]

        return cg_trace(
            residual, jnp.zeros((3, 3, 16), dt),
            lambda res, p: jax.vjp(res, p), jdx_of,
            lambda a, c: sum(jnp.sum(x * y) for x, y in zip(
                jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(c))),
            jnp.zeros_like)

    def port_trace(feats, lab_i):
        feats, lab_t = torch.tensor(np.asarray(feats)), torch.tensor(lab_i)

        def residual(filt):
            return {"data": classify(feats, filt) - lab_t,
                    "reg": 0.1 * filt}

        def jdx_of(res, p, vjp_fn):
            return lambda dx: vjp_fn(jvp(res, (p,), (dx,))[1])[0]

        return cg_trace(residual, torch.zeros(3, 3, 16), vjp, jdx_of,
                        lambda a, c: torch.sum(a * c), torch.zeros_like)

    names = ("pAp", "alpha", "rho")
    for i in range(2):
        feats = _jax_features(kern, bias, b["train_images"][i],
                              jnp.float32)
        lab_i = jnp.asarray(lab[i, "train_boxes"])
        j32, t32 = jax_trace(feats, lab_i, jnp.float32), port_trace(
            feats, lab[i, "train_boxes"])
        with jax.enable_x64():
            o64 = jax_trace(jnp.asarray(np.asarray(feats), jnp.float64),
                            lab[i, "train_boxes"], jnp.float64)
        print(f"sequence {i} (GN step, CG step: value relative off the "
              f"float64 oracle, JAX f32 / port f32)")
        for s in range(len(o64)):
            cells = ", ".join(
                f"{n} {abs(j32[s, c] / o64[s, c] - 1):.1e} / "
                f"{abs(t32[s, c] / o64[s, c] - 1):.1e}"
                for c, n in enumerate(names))
            print(f"  ({s // 3}, {s % 3}): {cells}")
        for name, tr in (("JAX f32", j32), ("port f32", t32)):
            off = np.abs(tr / o64 - 1) > 1e-4
            first = np.argwhere(off)
            where = (f"GN {first[0][0] // 3} CG {first[0][0] % 3} "
                     f"{names[first[0][1]]}" if len(first) else "never")
            print(f"  {name} first leaves the oracle by 1e-4 at {where}")


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
    {"siamese": siamese, "dimp": dimp, "dimp_cls": dimp_cls, "ops": ops,
     "solve": solve}[sys.argv[1]]()
