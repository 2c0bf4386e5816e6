"""Checkpoints as nested dicts of numpy arrays.

Port of :mod:`tao_amodal_tpu.utils.checkpoint` without flax: a tree is a
dict of dicts whose leaves are arrays, flattened to ``{"a/b/c": leaf}``
keys.  :func:`save_pytree` writes the single ``.npz`` that JAX's
``save_pytree`` writes (either package's :func:`load_pytree` reads
either's file), and :func:`load_pretrain` is the reference's
``load_pretrain`` contract (``pysot/utils/model_load.py``): prefix
stripping, and the loaded, missing, unused and mis-shaped keys reported.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def flatten(tree, prefix=()):
    """Nested dicts -> ``{"a/b/c": leaf}`` (an empty dict leaves no key,
    as ``flax.traverse_util.flatten_dict`` drops it)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = v
    return out


def unflatten(flat):
    """``{"a/b/c": leaf}`` -> nested dicts."""
    out = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def load_pretrain(params, pretrained, strip_prefix=None, check_shapes=True):
    """Merge the tree ``pretrained`` into ``params``: keys in both (after
    stripping ``strip_prefix``) are copied, shape mismatches skipped with
    a warning.  Returns ``(new tree, report)``, the report listing
    ``loaded``, ``missing``, ``unused`` and ``shape_mismatch`` keys."""
    tgt = flatten(params)
    src = flatten(pretrained)
    if strip_prefix:
        src = {(k[len(strip_prefix):] if k.startswith(strip_prefix) else k):
               v for k, v in src.items()}
    loaded, skipped = [], []
    for k, v in src.items():
        if k not in tgt:
            continue
        if check_shapes and np.shape(tgt[k]) != np.shape(v):
            skipped.append((k, np.shape(v), np.shape(tgt[k])))
            continue
        tgt[k] = v
        loaded.append(k)
    missing = sorted(set(tgt) - set(loaded))
    unused = sorted(set(src) - set(loaded) - {k for k, *_ in skipped})
    for k, got, want in skipped:
        logger.warning("shape mismatch for %s: %s vs %s", k, got, want)
    if missing:
        logger.info("%d params not in checkpoint (kept init)", len(missing))
    if unused:
        logger.info("%d checkpoint entries unused", len(unused))
    return unflatten(tgt), {"loaded": loaded, "missing": missing,
                            "unused": unused, "shape_mismatch": skipped}


def load_flat(path):
    """The flat ``{"a/b/c": ndarray}`` dict of a :func:`save_pytree`
    ``.npz``."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def save_pytree(path, pytree):
    """Write ``pytree`` (nested or already flat) as one ``.npz`` of its
    flattened leaves."""
    np.savez(path, **{k: np.asarray(v) for k, v in flatten(pytree).items()})


def load_pytree(path):
    """The nested tree of a :func:`save_pytree` ``.npz``."""
    return unflatten(load_flat(path))
