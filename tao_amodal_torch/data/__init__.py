"""Dataset APIs: the host-side JSON indices and result wrappers, with
the reference's public names (port of :mod:`tao_amodal_tpu.data`)."""

from tao_amodal_torch.data.tao import TaoDataset  # noqa: F401
from tao_amodal_torch.data.lvis import LvisDataset  # noqa: F401
from tao_amodal_torch.data.results import (  # noqa: F401
    TaoResultsDataset,
    LvisResultsDataset,
    make_track_ids_unique,
)

# Reference-compatible aliases (the reference exposes Tao/TaoResults/
# LVIS/LVISResults; ``tao_amodal/evaluation/tao_amodal/__init__.py``).
Tao = TaoDataset
TaoResults = TaoResultsDataset
LVIS = LvisDataset
LVISResults = LvisResultsDataset
