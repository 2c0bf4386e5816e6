"""Multi-host data feeding.

Port of :mod:`tao_amodal_tpu.parallel.host`: each process loads its
shard of the global batch (the reference's ``DistributedSampler``).  The
process index and count are ``torch.distributed``'s rank and world size
(0 and 1 without a process group).  JAX assembles the processes' shards
into one global array; a rank of the port keeps its own shard, which is
what :class:`~tao_amodal_torch.parallel.dp.DataParallelStep` takes.
"""

from __future__ import annotations

import numpy as np
import torch

from tao_amodal_torch.parallel.mesh import rank_and_world, tree_map


def host_shard_indices(total, process_index=None, process_count=None):
    """This process's slice of a global batch of size ``total``."""
    rank, world = rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    if total % pc:
        raise ValueError(f"a batch of {total} does not split over {pc} "
                         f"processes")
    per = total // pc
    return slice(pi * per, (pi + 1) * per)


def global_batch_from_local(mesh, local_batch, global_batch_size):
    """This rank's shard of the global batch, as tensors on the mesh's
    device: ``local_batch`` (numpy arrays or tensors, every leaf with the
    leading axis ``global_batch_size / data``), checked and moved."""
    per = global_batch_size // mesh.shape["data"]
    if per * mesh.shape["data"] != global_batch_size:
        raise ValueError(f"a batch of {global_batch_size} does not split "
                         f"over {mesh.shape['data']} data ranks")

    def place(x):
        x = torch.as_tensor(x)
        if x.shape[0] != per:
            raise ValueError(f"a local shard of {x.shape[0]} rows, not "
                             f"{global_batch_size} / {mesh.shape['data']}")
        return x.to(mesh.device)

    return tree_map(place, local_batch)


class ShardedSampler:
    """Deterministic per-process sample-index sharding (the
    DistributedSampler capability): process p takes indices ``p::count``
    of each epoch's permutation, ``RandomState(seed + epoch)``'s as in
    JAX."""

    def __init__(self, num_samples, seed=0, process_index=None,
                 process_count=None):
        rank, world = rank_and_world()
        self.num_samples = num_samples
        self.seed = seed
        self.pi = rank if process_index is None else process_index
        self.pc = world if process_count is None else process_count

    def epoch_indices(self, epoch):
        rng = np.random.RandomState(self.seed + epoch)
        order = rng.permutation(self.num_samples)
        return order[self.pi::self.pc]
