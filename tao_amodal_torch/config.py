"""Unified typed configuration tree.

Port of :mod:`tao_amodal_tpu.config` (the reference's four config systems
unified, survey §5: pysot's yacs ``CfgNode`` and experiment YAML,
pytracking's generated ``local.py``, per-script argparse and hardcoded
eval ``Params``): a nested dataclass tree with YAML merge
(``merge_from_file``, ``yaml`` imported only there), dotted-path
overrides (``merge_from_list``) and a workspace :class:`Settings` for
paths.  ``merge_from_list`` stores the values it is given as they are, as
JAX's does: ``["train.epochs", "1"]`` sets the string ``"1"``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple


def _merge_into(obj, data, path=""):
    for key, value in data.items():
        if not hasattr(obj, key):
            raise KeyError(f"Unknown config key: {path}{key}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _merge_into(current, value, path=f"{path}{key}.")
        else:
            setattr(obj, key, value)


@dataclasses.dataclass
class ConfigNode:
    """Base with yacs-style merge capabilities."""

    def merge_from_file(self, path):
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        _merge_into(self, data)
        return self

    def merge_from_dict(self, data):
        _merge_into(self, data)
        return self

    def merge_from_list(self, opts):
        """``["train.lr", 0.01, "track.penalty_k", 0.1]`` overrides."""
        assert len(opts) % 2 == 0, opts
        for key, value in zip(opts[0::2], opts[1::2]):
            obj = self
            *parents, leaf = key.split(".")
            for p in parents:
                obj = getattr(obj, p)
            if not hasattr(obj, leaf):
                raise KeyError(f"Unknown config key: {key}")
            setattr(obj, leaf, value)
        return self

    def to_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class BackboneConfig(ConfigNode):
    type: str = "resnet50"
    atrous: bool = True
    out_stages: Tuple[int, ...] = (2, 3, 4)
    width_mult: float = 1.0


@dataclasses.dataclass
class TrackConfig(ConfigNode):
    """Siamese tracking hyperparameters (reference cfg.TRACK/ANCHOR)."""

    exemplar_size: int = 127
    instance_size: int = 255
    base_size: int = 8
    context_amount: float = 0.5
    stride: int = 8
    ratios: Tuple[float, ...] = (0.33, 0.5, 1.0, 2.0, 3.0)
    scales: Tuple[float, ...] = (8,)
    penalty_k: float = 0.04
    window_influence: float = 0.44
    lr: float = 0.4


@dataclasses.dataclass
class DetectorConfig(ConfigNode):
    num_classes: int = 1230  # LVIS v0.5-style label space
    num_dets: int = 64
    num_proposals: int = 256
    score_threshold: float = 0.05
    nms_threshold: float = 0.5
    dtype: str = "bfloat16"


@dataclasses.dataclass
class SortConfig(ConfigNode):
    max_age: int = 1
    min_hits: int = 3
    iou_threshold: float = 0.3
    max_tracks: int = 128


@dataclasses.dataclass
class TrainSection(ConfigNode):
    epochs: int = 20
    batch_size: int = 64
    start_lr: float = 1e-2
    end_lr: float = 1e-4
    warmup_epochs: int = 5
    weight_decay: float = 1e-4
    momentum: float = 0.9
    grad_clip: float = 10.0
    backbone_train_epoch: int = 10
    cls_weight: float = 1.0
    loc_weight: float = 1.2


@dataclasses.dataclass
class MeshConfig(ConfigNode):
    data: Optional[int] = None  # None = all devices
    model: int = 1


@dataclasses.dataclass
class Config(ConfigNode):
    backbone: BackboneConfig = dataclasses.field(
        default_factory=BackboneConfig)
    track: TrackConfig = dataclasses.field(default_factory=TrackConfig)
    detector: DetectorConfig = dataclasses.field(
        default_factory=DetectorConfig)
    sort: SortConfig = dataclasses.field(default_factory=SortConfig)
    train: TrainSection = dataclasses.field(default_factory=TrainSection)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def default_config():
    return Config()


@dataclasses.dataclass
class Settings:
    """Workspace paths (capability of pytracking's generated
    ``local.py``; reference ``ltr/admin/environment.py:19-59``) —
    env-var driven instead of code generation."""

    workspace_dir: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "TAO_AMODAL_WORKSPACE", os.path.expanduser("~/tao_amodal")))
    dataset_dir: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "TAO_AMODAL_DATA", ""))
    checkpoint_dir: str = ""
    tensorboard_dir: str = ""
    result_dir: str = ""

    def __post_init__(self):
        self.checkpoint_dir = self.checkpoint_dir or os.path.join(
            self.workspace_dir, "checkpoints")
        self.tensorboard_dir = self.tensorboard_dir or os.path.join(
            self.workspace_dir, "tensorboard")
        self.result_dir = self.result_dir or os.path.join(
            self.workspace_dir, "results")


def env_settings():
    return Settings()
