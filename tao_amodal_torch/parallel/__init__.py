"""Scale-out: the ``('data', 'model')`` mesh over ranks, data- and
tensor-parallel training, context-parallel evaluation, host pools.

Port of :mod:`tao_amodal_tpu.parallel`.  JAX drives every device from
one controller and lets GSPMD insert the collectives; the port runs one
process a device (``torch.distributed``, started by
:func:`tao_amodal_torch.parallel.launch.run_ranks`) and makes the
collectives itself: NCCL where each rank has its own card, gloo on the
CPU and for ranks that share a card.
"""

from tao_amodal_torch.parallel.mesh import make_mesh  # noqa: F401
from tao_amodal_torch.parallel.dp import make_train_step  # noqa: F401
from tao_amodal_torch.parallel.tp import (  # noqa: F401
    place_tp,
    tp_param_shardings,
)
from tao_amodal_torch.parallel.cp import sharded_track_iou  # noqa: F401
from tao_amodal_torch.parallel.pool import (  # noqa: F401
    FixedDevicePool,
    PoolWithContext,
)
