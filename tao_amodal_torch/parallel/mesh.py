"""The ``('data', 'model')`` layout over the ranks of a process group.

Port of :mod:`tao_amodal_tpu.parallel.mesh`.  JAX lays its devices out
as ``np.array(devices).reshape(data, model)`` and lets GSPMD insert the
collectives; the port runs one process per device (PyTorch's own idiom,
``torch.distributed``) and lays the ranks out the same way: rank ``r``
sits at ``(r // model, r % model)``.  Its ``data`` group is the ranks of
its column (same model index: the ranks whose gradients it averages), its
``model`` group the ranks of its row (same data index: the ranks that
share one batch shard and split the tensor-parallel heads).

Without an initialised process group the mesh is one rank (``{data: 1,
model: 1}``), and every collective of :mod:`tao_amodal_torch.parallel`
is the identity, so the same code runs in one process.

The backend is the caller's choice (:func:`tao_amodal_torch.parallel.
launch.run_ranks`): NCCL where each rank has its own card, gloo on the
CPU and for ranks that share a card.  ``device`` is this rank's device:
``"cuda"`` (the default) is card ``rank``, one card a rank; any other
string (``"cuda:0"``, ``"cpu"``) is taken as it is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def rank_and_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """This rank's place in the ``('data', 'model')`` layout.

    ``shape`` is ``{"data": d, "model": m}`` (JAX's ``mesh.shape``);
    ``data_index`` and ``model_index`` are the rank's coordinates;
    ``data_group`` and ``model_group`` its process groups (``None`` in one
    process without a group: nothing to reduce; an axis of one rank in a
    group still runs its collectives, which leave the values as they
    are); ``device`` its device.
    """

    def __init__(self, data, model, device):
        self.rank, self.world = rank_and_world()
        if data * model != self.world:
            raise ValueError(f"mesh {data} x {model} does not cover the "
                             f"{self.world} ranks")
        self.shape = {"data": data, "model": model}
        self.data_index, self.model_index = divmod(self.rank, model)
        grid = np.arange(self.world).reshape(data, model)
        # Every rank creates every group, in one order (new_group is
        # collective over the whole world).
        self.data_group = self._groups(grid.T, self.model_index)
        self.model_group = self._groups(grid, self.data_index)
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", self.rank)
        self.device = device

    def _groups(self, rows, mine):
        """The group of ``rows[mine]`` (each row one group), made on
        every rank; None without a process group."""
        if not (dist.is_available() and dist.is_initialized()):
            return None
        if rows.shape[0] == 1:
            return dist.group.WORLD
        groups = [dist.new_group([int(r) for r in row]) for row in rows]
        return groups[mine]


def make_mesh(data=None, model=1, device="cuda"):
    """The ``('data', 'model')`` mesh over the world's ranks (JAX's
    ``make_mesh``): ``data`` defaults to the world size over ``model``."""
    _, world = rank_and_world()
    if data is None:
        if world % model:
            raise ValueError(f"model={model} does not divide the "
                             f"{world} ranks")
        data = world // model
    return Mesh(data, model, device)


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """``t`` reduced in place over ``group`` (nothing where the group is
    None: one rank)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def data_sharding(mesh, n):
    """This rank's slice of a leading axis of ``n`` over ``data``: JAX's
    ``data_sharding`` seen from one rank (equal shards in rank order)."""
    d = mesh.shape["data"]
    if n % d:
        raise ValueError(f"a leading axis of {n} does not split over "
                         f"{d} data ranks")
    per = n // d
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def tree_map(fn, tree):
    """``fn`` on every array leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh, batch):
    """This rank's slice of the leading axis of every leaf of ``batch``
    (numpy arrays or tensors), as tensors on the mesh's device: JAX's
    ``shard_batch``, seen from one rank."""
    def shard(x):
        x = torch.as_tensor(x)
        return x[data_sharding(mesh, x.shape[0])].to(mesh.device)

    return tree_map(shard, batch)
