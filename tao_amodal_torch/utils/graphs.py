"""CUDA graphs over functions of tensor pytrees: the port's ``jax.jit``.

:func:`capture` wraps a function of tensors (alone or in tuples, lists,
dicts and NamedTuples such as ``SortState``) as JAX's ``jax.jit`` wraps
one: the first call at an input geometry (the tree's structure, each
tensor's shape, dtype and device, and the non-tensor leaves' values)
builds the program, here a ``torch.cuda.CUDAGraph`` of every kernel the
function launches, and later calls at that geometry replay it.  Each
geometry keeps its own graph, as ``jax.jit`` compiles once per geometry.

A capture first warms the function up on a side stream, with the
caller's own inputs: every lazily built constant (anchors, the Kalman
matrices, the level table of the RoI canvas, bf16 and int8 weight
copies, split-K counters, cuBLAS and cuDNN handles) exists before the
capture, which must copy nothing from the host.  The inputs live in
static buffers that each call copies into; the outputs are cloned out of
the graph's memory pool, so that a result outlives the next call, as a
JAX array does.

What a graph holds is what the function did at capture: the same
kernels on the same buffers and the same weights (a later load of
weights that rebuilds a cached copy needs a new :func:`capture`), and
Python side effects (launch counters) happen at warm-up and capture
only.  On the CPU the function runs as it is: the caller asked for the
CPU.  On CUDA a failed capture raises; it never falls back to eager.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

# Eager calls before a capture: the first builds every lazy constant and
# picks cuDNN's and cuBLAS's algorithms, the second runs as the capture
# will.
WARMUP = 2


def _flatten(tree, leaves):
    """Append the leaves of ``tree`` to ``leaves``; return its structure
    (hashable: container types, dict keys, ``None`` for a leaf)."""
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        keys = tuple(tree)
        return (dict, keys, tuple(_flatten(tree[k], leaves) for k in keys))
    leaves.append(tree)
    return None


def _unflatten(spec, leaves):
    """The tree of structure ``spec`` over the iterator ``leaves``."""
    if spec is None:
        return next(leaves)
    if spec[0] is dict:
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    kind, children = spec
    values = [_unflatten(s, leaves) for s in children]
    return kind(*values) if hasattr(kind, "_fields") else kind(values)


def _tree_map(fn, tree):
    """``tree`` with ``fn`` applied to every tensor leaf."""
    leaves = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, iter(
        fn(x) if torch.is_tensor(x) else x for x in leaves))


class _Graph(NamedTuple):
    """One geometry's graph, its static inputs and outputs."""

    graph: object
    inputs: list
    outputs: object


class CapturedFn:
    """``fn`` served from one CUDA graph per input geometry (see the
    module's docstring).  ``graphs`` maps each geometry to its graph;
    ``capture_ms`` lists the wall ms of each capture, warm-up included,
    in order."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs = {}
        self.capture_ms = []

    def __call__(self, *args):
        leaves = []
        spec = _flatten(args, leaves)
        tensors = [x for x in leaves if torch.is_tensor(x)]
        devices = {t.device for t in tensors}
        if all(d.type == "cpu" for d in devices):
            return self.fn(*args)
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"capture: every tensor input must lie on one "
                             f"CUDA device, got {sorted(map(str, devices))}")
        key = (spec, tuple(
            (tuple(x.shape), x.dtype, x.device) if torch.is_tensor(x)
            else ("static", x) for x in leaves))
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(spec, leaves)
        else:
            for dst, src in zip(entry.inputs, tensors):
                dst.copy_(src)
        entry.graph.replay()
        return _tree_map(torch.clone, entry.outputs)

    def _capture(self, spec, leaves):
        """Warm ``fn`` up on a side stream, then capture one call."""
        inputs = [x.clone() for x in leaves if torch.is_tensor(x)]
        feed = iter(inputs)
        args = _unflatten(spec, iter(
            next(feed) if torch.is_tensor(x) else x for x in leaves))
        dev = inputs[0].device
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            caller = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    self.fn(*args)
            caller.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outputs = self.fn(*args)
            torch.cuda.synchronize(dev)
        self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        return _Graph(graph, inputs, outputs)


def capture(fn):
    """``fn`` as a :class:`CapturedFn`: one CUDA graph per input
    geometry, :data:`WARMUP` eager calls on a side stream before each
    capture; on CPU inputs ``fn`` itself."""
    return CapturedFn(fn)
