"""Dataset configuration: the fields of ``vision_mtl_tpu/cfg.py`` (and
``data/synthetic.py``) that the serving and evaluation path reads."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset_name: str
    height: int
    width: int
    num_classes: int


cityscapes_data_cfg = DataConfig("cityscapes", height=128, width=256, num_classes=19)
synthetic_data_cfg = DataConfig("synthetic", height=64, width=64, num_classes=7)


def fetch_data_cfg(dataset_name: str) -> DataConfig:
    """Resolve a dataset name to its config."""
    configs = {c.dataset_name: c for c in (cityscapes_data_cfg, synthetic_data_cfg)}
    if dataset_name not in configs:
        raise ValueError(f"Unknown dataset name {dataset_name}")
    return configs[dataset_name]
