"""Online-learning inner solvers: CG, Gauss-Newton CG, GD-L2.

Port of ``tao_amodal_tpu/ops/optimization.py`` (itself the reference's
``pytracking/libs/optimization.py``: ``run_CG`` :72-164, ``GaussNewtonCG``
:293-420, ``GradientDescentL2``).  Parameters and residuals are trees: a
tensor, or dicts, lists and tuples of them; a dict's leaves are taken in
sorted key order, as JAX's tree utilities take them, so every reduction
sums in JAX's order.

Jacobian products come from ``torch.func``: one ``vjp`` a Gauss-Newton
step (the residual at the point and ``J^T``), one ``jvp`` a CG product
(``J dx``, the forward recomputed with its tangent; ``torch.func.
linearize`` would retrace the residual every step, host work the
``jvp`` avoids).  The iteration counts are Python ints and the guards
of CG (``pAp > eps``, ``rho > 0``) are ``torch.where`` on the device, so
a solve makes no host sync.  The transforms differentiate whatever the
caller's grad mode is.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def tree_leaves(tree):
    """The tensors of ``tree`` in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the trees ``rest`` of the
    same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_dot(a, b):
    """``sum(a * b)`` over every leaf, the leaves' sums added in order."""
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        s = torch.sum(x * y)
        total = s if total is None else total + s
    return total


def tree_axpy(alpha, x, y):
    """``alpha * x + y`` over trees."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def conjugate_gradient(A: Callable, b, x0=None, num_iters=10, eps=0.0):
    """Solve ``A x = b`` for an SPD operator ``A`` over trees (JAX's
    ``conjugate_gradient``: Fletcher-Reeves beta, and the early-exit
    guards as masked updates)."""
    if x0 is None:
        x = tree_map(torch.zeros_like, b)
        r = b
    else:
        x = x0
        r = tree_axpy(-1.0, A(x0), b)
    p = r
    rho = tree_dot(r, r)
    for _ in range(num_iters):
        Ap = A(p)
        pAp = tree_dot(p, Ap)
        ok = pAp > eps
        alpha = torch.where(ok, rho / torch.where(ok, pAp, 1.0), 0.0)
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, Ap, r)
        rho_new = tree_dot(r, r)
        pos = rho > 0
        beta = torch.where(pos, rho_new / torch.where(pos, rho, 1.0), 0.0)
        p = tree_axpy(beta, p, r)
        rho = rho_new
    return x


class GNState(NamedTuple):
    """A Gauss-Newton solve's parameters and its losses (JAX's
    ``GNState``)."""
    params: Any
    losses: torch.Tensor


def gauss_newton_cg(residual_fn: Callable, params, num_gn_iters=6,
                    num_cg_iters=10, reg=0.0):
    """Gauss-Newton with CG inner solves (JAX's ``gauss_newton_cg``).

    ``residual_fn``: ``params -> residual tree`` (loss ``0.5 *
    ||r||^2``).  Each outer step linearizes the residual at ``params``
    and CG-solves ``(J^T J + reg) dx = -J^T r``.

    Returns ``(params, losses [num_gn_iters + 1])``: the loss before
    each step and after the last.
    """
    from torch.func import jvp, vjp

    losses = []
    for _ in range(num_gn_iters):
        r0, vjp_fn = vjp(residual_fn, params)
        losses.append(0.5 * tree_dot(r0, r0))
        point = params

        def normal_op(dx, point=point, vjp_fn=vjp_fn):
            jdx = jvp(residual_fn, (point,), (dx,))[1]
            jtj = vjp_fn(jdx)[0]
            if reg:
                jtj = tree_axpy(reg, dx, jtj)
            return jtj

        b = tree_map(torch.neg, vjp_fn(r0)[0])
        dx = conjugate_gradient(normal_op, b, num_iters=num_cg_iters)
        params = tree_axpy(1.0, dx, params)
    with torch.no_grad():
        r = residual_fn(params)
    losses.append(0.5 * tree_dot(r, r))
    return params, torch.stack(losses)


def gradient_descent_l2(loss_fn: Callable, params, num_iters=10,
                        step_length=1e-2, momentum=0.0):
    """Gradient descent with momentum over a tree (JAX's
    ``gradient_descent_l2``, the reference ``GradientDescentL2``)."""
    from torch.func import grad

    grad_fn = grad(loss_fn)
    v = tree_map(torch.zeros_like, params)
    for _ in range(num_iters):
        g = grad_fn(params)
        v = tree_map(lambda vi, gi: momentum * vi + gi, v, g)
        params = tree_axpy(-step_length, v, params)
    return params
