"""Evaluation engines: Track-mAP (3D IoU) and amodal detection AP.

The port of :mod:`tao_amodal_tpu.evaluation` (bbox and segm): the
float64 host evaluators, numpy copies of the JAX package's (themselves
metric-parity rebuilds of the reference's ``TaoEval`` and amodal
``LVISEval``), and the device evaluators in PyTorch on a chosen device
(segm: mask IoU on the host through the RLE codec, the matching on the
device).
"""

from tao_amodal_torch.evaluation.params import (  # noqa: F401
    DetectionEvalParams,
    TrackEvalParams,
)
from tao_amodal_torch.evaluation.track_eval import TrackMapEvaluator  # noqa: F401
from tao_amodal_torch.evaluation.detection_eval import (  # noqa: F401
    AmodalDetectionEvaluator,
)
from tao_amodal_torch.evaluation.device_eval import DeviceTrackEval  # noqa: F401
from tao_amodal_torch.evaluation.device_detection import (  # noqa: F401
    DeviceDetectionEval,
)

# Reference-compatible aliases.
TaoEval = TrackMapEvaluator
LVISEval = AmodalDetectionEvaluator
