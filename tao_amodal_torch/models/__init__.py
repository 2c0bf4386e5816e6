"""Model zoo: PyTorch modules with the Flax modules' names, so the
weight bridge (:mod:`tao_amodal_torch.utils.weights`) maps the JAX
package's variables one to one (port of :mod:`tao_amodal_tpu.models`):
the ResNet, AlexNet and MobileNetV2 trunks, the Siamese trackers' model,
the clip detector and the Amodal Expander."""

from tao_amodal_torch.models.backbones import (  # noqa: F401
    AlexNet,
    MobileNetV2,
    ResNet,
    resnet50,
)
from tao_amodal_torch.models.siamese import SiameseTracker  # noqa: F401
from tao_amodal_torch.models.detector import ClipDetector  # noqa: F401
from tao_amodal_torch.models.amodal_expander import (  # noqa: F401
    AmodalExpander,
)
