"""Context (frame)-parallel track IoU over the mesh.

Port of :mod:`tao_amodal_tpu.parallel.cp`.  3D track IoU is ``sum_f I /
sum_f U``, which decomposes exactly over frame shards: each rank takes
its slice of the frame axis, computes the partial (I, U) sums with
:func:`tao_amodal_torch.ops.track_iou.track_iou_partials`, and one
``all_reduce`` over ``data`` sums them into the whole video's, on every
rank (JAX's ``psum`` in a ``shard_map``).  Long videos' evaluation then
spreads over the ranks without changing a metric.
"""

from __future__ import annotations

import torch

from tao_amodal_torch.parallel.mesh import all_reduce
from tao_amodal_torch.ops.track_iou import track_iou_partials


def sharded_track_iou(mesh, dt_boxes, dt_valid, gt_boxes, gt_valid):
    """Exact 3D track-IoU matrix with the frames split over ``data``.

    Args:
      dt_boxes: ``[D, F, 4]`` xywh (tensors or numpy, the whole video on
        every rank), F divisible by the data-axis size; ``dt_valid [D,
        F]``.
      gt_boxes: ``[G, F, 4]``; ``gt_valid [G, F]``.

    Returns ``[D, G]`` f32 on the mesh's device, the same on every rank.
    """
    n = mesh.shape["data"]
    F = dt_boxes.shape[1]
    if F % n:
        raise ValueError(f"{F} frames do not split over {n} data ranks")
    per = F // n
    frames = slice(mesh.data_index * per, (mesh.data_index + 1) * per)

    def local(x):
        return torch.as_tensor(x)[:, frames].to(mesh.device)

    i_part, u_part = track_iou_partials(local(dt_boxes), local(dt_valid),
                                        local(gt_boxes), local(gt_valid))
    sums = all_reduce(torch.stack([i_part, u_part]).to(torch.float32),
                      mesh.data_group)
    i_tot, u_tot = sums[0], sums[1]
    return torch.where(u_tot > 0,
                       i_tot / torch.where(u_tot > 0, u_tot, 1.0), 0.0)
