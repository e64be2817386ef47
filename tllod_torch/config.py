"""Immutable, hashable configuration system (copy of ``tllod_tpu/config.py``).

Frozen dataclasses with the reference's key surface (TRAIN.*, TEST.*,
RESNET.*, pooling / anchor / stride keys), the YAML merge of
``cfg_from_file`` and the ``KEY.SUBKEY value`` overrides of
``cfg_from_list``. Values are tuples, never lists, so configs hash.

``yaml`` is imported inside :func:`cfg_from_file` only, so the package and
``chip_smoke.py`` run where ``yaml`` is not installed; they set keys through
:func:`cfg_from_list` alone.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence, Tuple


@dataclass(frozen=True)
class TrainConfig:
    """Training options (reference ``config.py:19-161``)."""

    LEARNING_RATE: float = 0.001
    MOMENTUM: float = 0.9
    WEIGHT_DECAY: float = 0.0005
    GAMMA: float = 0.1
    STEPSIZE: Tuple[int, ...] = (30000,)
    DISPLAY: int = 10
    DOUBLE_BIAS: bool = True
    TRUNCATED: bool = False
    BIAS_DECAY: bool = False
    USE_GT: bool = False
    ASPECT_GROUPING: bool = False
    SNAPSHOT_KEPT: int = 3
    SUMMARY_INTERVAL: int = 180
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    TRIM_HEIGHT: int = 600
    TRIM_WIDTH: int = 600
    IMS_PER_BATCH: int = 1
    BATCH_SIZE: int = 128          # RoIs sampled per image by proposal-target
    FG_FRACTION: float = 0.25
    FG_THRESH: float = 0.5
    BG_THRESH_HI: float = 0.5
    BG_THRESH_LO: float = 0.1
    USE_FLIPPED: bool = True
    BBOX_REG: bool = True
    BBOX_THRESH: float = 0.5
    SNAPSHOT_ITERS: int = 5000
    SNAPSHOT_PREFIX: str = "res101_faster_rcnn"
    BBOX_NORMALIZE_TARGETS: bool = True
    BBOX_INSIDE_WEIGHTS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    BBOX_NORMALIZE_TARGETS_PRECOMPUTED: bool = True
    BBOX_NORMALIZE_MEANS: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    BBOX_NORMALIZE_STDS: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    PROPOSAL_METHOD: str = "gt"
    HAS_RPN: bool = True
    RPN_POSITIVE_OVERLAP: float = 0.7
    RPN_NEGATIVE_OVERLAP: float = 0.3
    RPN_CLOBBER_POSITIVES: bool = False
    RPN_FG_FRACTION: float = 0.5
    RPN_BATCHSIZE: int = 256
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 12000
    RPN_POST_NMS_TOP_N: int = 2000
    RPN_MIN_SIZE: int = 8
    RPN_BBOX_INSIDE_WEIGHTS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    RPN_POSITIVE_WEIGHT: float = -1.0
    USE_ALL_GT: bool = True
    BN_TRAIN: bool = False


@dataclass(frozen=True)
class TestConfig:
    """Testing options (reference ``config.py:166-208``)."""

    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    NMS: float = 0.3
    SVM: bool = False
    BBOX_REG: bool = True
    HAS_RPN: bool = False
    PROPOSAL_METHOD: str = "gt"
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 6000
    RPN_POST_NMS_TOP_N: int = 300
    RPN_MIN_SIZE: int = 16
    MODE: str = "nms"
    RPN_TOP_N: int = 5000


@dataclass(frozen=True)
class ResNetConfig:
    """ResNet options (reference ``config.py:214-224``)."""

    MAX_POOL: bool = False
    FIXED_BLOCKS: int = 1


@dataclass(frozen=True)
class MobileNetConfig:
    """MobileNet options (reference ``config.py:230-243``)."""

    REGU_DEPTH: bool = False
    FIXED_LAYERS: int = 5
    WEIGHT_DECAY: float = 0.00004
    DEPTH_MULTIPLIER: float = 1.0


@dataclass(frozen=True)
class Config:
    """Top-level config (reference ``config.py:246-305`` misc keys)."""

    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    RESNET: ResNetConfig = field(default_factory=ResNetConfig)
    MOBILENET: MobileNetConfig = field(default_factory=MobileNetConfig)

    DSN_DIFF_WEIGHT: float = 100000.0
    DEDUP_BOXES: float = 1.0 / 16.0
    # Pixel mean values in BGR order (reference config.py:259).
    PIXEL_MEANS: Tuple[float, ...] = (102.9801, 115.9465, 122.7717)
    RNG_SEED: int = 3
    EPS: float = 1e-14
    DATA_DIR: str = "data"
    EXP_DIR: str = "default"
    MATLAB: str = "matlab"
    USE_GPU_NMS: bool = True
    GPU_ID: int = 0
    POOLING_MODE: str = "crop"
    POOLING_SIZE: int = 7
    MAX_NUM_GT_BOXES: int = 20
    ANCHOR_SCALES: Tuple[float, ...] = (4, 8, 16, 32)
    ANCHOR_RATIOS: Tuple[float, ...] = (0.5, 1, 2)
    FEAT_STRIDE: Tuple[int, ...] = (16,)
    CUDA: bool = False
    CROP_RESIZE_WITH_MAX_POOL: bool = True

    def get(self, dotted: str) -> Any:
        """Look up ``"TRAIN.RPN_NMS_THRESH"``-style dotted keys."""
        node: Any = self
        for part in dotted.split("."):
            node = getattr(node, part)
        return node

    def rpn_cfg(self, training: bool) -> "TrainConfig | TestConfig":
        """The TRAIN/TEST sub-config the proposal layer reads
        (reference ``rpn.py:75``: ``cfg_key = 'TRAIN' if training else 'TEST'``)."""
        return self.TRAIN if training else self.TEST


def _coerce(old: Any, new: Any, key: str) -> Any:
    """Type-checked coercion mirroring ``_merge_a_into_b``
    (reference ``config.py:340-370``): sequences become tuples, and a type
    mismatch is an error unless a safe numeric widening applies."""
    if isinstance(old, tuple):
        if not isinstance(new, (list, tuple)):
            raise ValueError(f"Type mismatch for config key {key}: "
                             f"{type(new).__name__} vs tuple")
        return tuple(new)
    if isinstance(old, bool):
        if not isinstance(new, bool):
            raise ValueError(f"Type mismatch for config key {key}")
        return new
    if isinstance(old, float) and isinstance(new, (int, float)):
        return float(new)
    if isinstance(old, int) and isinstance(new, int):
        return new
    if isinstance(old, str) and isinstance(new, str):
        return new
    raise ValueError(
        f"Type mismatch ({type(old).__name__} vs {type(new).__name__}) "
        f"for config key: {key}")


def _merge(node: Any, updates: Mapping[str, Any], prefix: str = "") -> Any:
    """Recursively merge a plain dict into a frozen dataclass, returning a new
    instance. Unknown keys raise KeyError (reference ``config.py:349-350``)."""
    if not dataclasses.is_dataclass(node):
        raise TypeError(f"Cannot merge into non-dataclass at {prefix!r}")
    names = {f.name for f in dataclasses.fields(node)}
    changes = {}
    for key, val in updates.items():
        if key not in names:
            raise KeyError(f"{prefix}{key} is not a valid config key")
        old = getattr(node, key)
        if dataclasses.is_dataclass(old):
            if not isinstance(val, Mapping):
                raise ValueError(f"Config key {prefix}{key} expects a mapping")
            changes[key] = _merge(old, val, prefix=f"{prefix}{key}.")
        else:
            changes[key] = _coerce(old, val, f"{prefix}{key}")
    return dataclasses.replace(node, **changes)


def cfg_from_file(cfg: Config, filename: str) -> Config:
    """Load a YAML file and merge it over ``cfg``
    (reference ``cfg_from_file``, ``config.py:373-379``)."""
    import yaml

    with open(filename) as f:
        data = yaml.safe_load(f) or {}
    return _merge(cfg, data)


def cfg_from_list(cfg: Config, kv_list: Sequence[str]) -> Config:
    """Apply ``["KEY.SUBKEY", "value", ...]`` CLI overrides
    (reference ``cfg_from_list``, ``config.py:382-402``)."""
    from ast import literal_eval

    assert len(kv_list) % 2 == 0, "--set expects KEY VALUE pairs"
    out = cfg
    for key, raw in zip(kv_list[0::2], kv_list[1::2]):
        try:
            value = literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node: Mapping[str, Any] = {key.split(".")[-1]: value}
        for part in reversed(key.split(".")[:-1]):
            node = {part: node}
        out = _merge(out, node)
    return out


def default_config() -> Config:
    return Config()
