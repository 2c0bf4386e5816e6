"""Trackers: multi-object association (SORT) and the single-object
trackers (port of :mod:`tao_amodal_tpu.trackers`)."""

from tao_amodal_torch.trackers.sort import Sort, SortState  # noqa: F401
from tao_amodal_torch.trackers.base import Tracker  # noqa: F401
