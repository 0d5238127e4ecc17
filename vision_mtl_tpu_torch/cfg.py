"""Pipeline and dataset configuration (counterpart of ``vision_mtl_tpu/cfg.py``).

The dataset configs carry the fields the data pipeline, the models and the
CLI read, with the JAX package's names and defaults. They are mutable
singletons: the CLI points ``data_dir`` at another tree, and the datasets
read their config when they are built, not when they are imported.
``cfg`` is the pipeline singleton (seed, run-dir root).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import typing as t
from pathlib import Path

root_dir = Path(__file__).parent


@dataclasses.dataclass
class ResizeSpec:
    """Declarative resize: images bilinear, masks nearest
    (``data/transforms.py``). The bilinear resize always averages over the
    source area on a downscale (antialiased), as PIL's does."""

    height: int
    width: int


@dataclasses.dataclass
class DataConfig:
    dataset_name: str = ""

    data_dir: str = str(root_dir / "data")
    batch_size: int = 4
    num_workers: int = 0
    shuffle_train: bool = True
    train_size: float = 0.8

    height: int = 0
    width: int = 0

    num_classes: int = 0
    class_names: t.List[str] = dataclasses.field(default_factory=list)

    # depth is divided by max_depth when a sample's values exceed 1
    max_depth: float = 1.0

    train_transform: t.Optional[ResizeSpec] = None
    test_transform: t.Optional[ResizeSpec] = None

    # host-to-device wire: "f32" (exact) or "compact" (uint8 images, uint16
    # depth, uint8 masks; decoded on the device, data/loader.compress_batch)
    wire_format: str = "f32"


def _cityscapes_class_names() -> t.List[str]:
    # 19 classes and a trailing "artifact" entry: the ignore id -1 is folded
    # into the last class id, 18
    return [
        "road", "sidewalk", "building", "wall", "fence", "pole",
        "traffic light", "traffic sign", "vegetation", "terrain", "sky",
        "person", "rider", "car", "truck", "bus", "train", "motorcycle",
        "bicycle", "artifact",
    ]


@dataclasses.dataclass
class CityscapesConfig(DataConfig):
    dataset_name: str = "cityscapes"
    data_dir: str = str(root_dir / "data" / "cityscapes")

    height: int = 128
    width: int = 256

    num_classes: int = 19
    class_names: t.List[str] = dataclasses.field(default_factory=_cityscapes_class_names)

    max_depth: float = 1.0

    batch_size: int = 8
    num_workers: int = 4
    wire_format: str = "compact"

    train_transform: ResizeSpec = dataclasses.field(default_factory=lambda: ResizeSpec(128, 256))
    test_transform: ResizeSpec = dataclasses.field(default_factory=lambda: ResizeSpec(128, 256))


def _nyuv2_class_names() -> t.List[str]:
    return [
        "background", "bed", "books", "ceiling", "chair", "floor",
        "furniture", "objects", "painting", "sofa", "table", "tv",
        "wall", "window",
    ]


@dataclasses.dataclass
class NYUv2Config(DataConfig):
    dataset_name: str = "nyuv2"
    data_dir: str = str(root_dir / "data" / "nyuv2")

    # the source size; the transforms resize to 256x256
    height: int = 480
    width: int = 640

    num_classes: int = 13 + 1
    class_names: t.List[str] = dataclasses.field(default_factory=_nyuv2_class_names)

    max_depth: float = 10.0

    # antialiased bilinear, on every stream
    train_transform: ResizeSpec = dataclasses.field(default_factory=lambda: ResizeSpec(256, 256))
    test_transform: ResizeSpec = dataclasses.field(default_factory=lambda: ResizeSpec(256, 256))


@dataclasses.dataclass
class PipelineConfig:
    seed: int = 11

    # run-dir root; VMTL_LOG_ROOT redirects it
    log_root_dir: Path = dataclasses.field(
        default_factory=lambda: Path(
            os.environ.get("VMTL_LOG_ROOT", str(root_dir / "lightning_logs"))
        )
    )

    def update_fields_with_args(self, args: argparse.Namespace) -> None:
        """Copy the parsed CLI args that name a field of this config."""
        for k, v in vars(args).items():
            if hasattr(self, k):
                setattr(self, k, v)


cityscapes_data_cfg = CityscapesConfig()
nyuv2_data_cfg = NYUv2Config()

cfg = PipelineConfig()


def fetch_data_cfg(dataset_name: str) -> DataConfig:
    """Resolve a dataset name to its config singleton."""
    if dataset_name == "cityscapes":
        return cityscapes_data_cfg
    if dataset_name == "nyuv2":
        return nyuv2_data_cfg
    if dataset_name == "synthetic":
        from vision_mtl_tpu_torch.data.synthetic import synthetic_data_cfg

        return synthetic_data_cfg
    raise ValueError(f"Unknown dataset name {dataset_name}")
