"""Pipeline and dataset configuration (counterpart of ``vision_mtl_tpu/cfg.py``).

The dataset configs carry the fields the data pipeline, the models and the
CLI read, with the JAX package's names and defaults. They are mutable
singletons: the CLI points ``data_dir`` at another tree, and the datasets
read their config when they are built, not when they are imported.
``cfg`` is the pipeline singleton (seed, run-dir root, the comet
credentials and the masks' palette).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import typing as t
from pathlib import Path

import numpy as np

root_dir = Path(__file__).parent


def _load_dotenv(path: Path) -> None:
    """``KEY=value`` lines of an optional ``.env`` file (the comet
    credentials) into the environment, without overriding it; matching
    quotes around a value are stripped."""
    if not path.exists():
        return
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, v = line.split("=", 1)
        v = v.strip()
        if len(v) >= 2 and v[0] == v[-1] and v[0] in "\"'":
            v = v[1:-1]
        os.environ.setdefault(k.strip(), v)


_load_dotenv(root_dir / ".env")


@dataclasses.dataclass
class LoggerConfig:
    """Comet credentials from the environment; tracking is disabled
    without them."""

    api_key: t.Optional[str] = dataclasses.field(
        default_factory=lambda: os.environ.get("comet_api_key")
    )
    username: t.Optional[str] = dataclasses.field(
        default_factory=lambda: os.environ.get("comet_username")
    )
    project_name: str = "vision-mtl"
    disabled: bool = dataclasses.field(init=False)

    def __post_init__(self) -> None:
        self.disabled = self.api_key is None or self.username is None


@dataclasses.dataclass
class VisConfig:
    # the 20-colour RGB palette of the mask overlays
    rgb_palette: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(
            [
                [63, 171, 212], [109, 137, 117], [24, 83, 42], [148, 77, 185],
                [122, 139, 58], [32, 126, 85], [17, 164, 215], [124, 39, 146],
                [161, 239, 20], [40, 81, 119], [149, 34, 38], [166, 224, 205],
                [134, 100, 230], [123, 157, 137], [11, 5, 225], [60, 84, 80],
                [173, 186, 12], [199, 91, 22], [170, 124, 184], [119, 102, 69],
            ]
        )
    )


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
    logger: LoggerConfig = dataclasses.field(default_factory=LoggerConfig)
    vis: VisConfig = dataclasses.field(default_factory=VisConfig)

    seed: int = 11

    # run-dir root; VMTL_LOG_ROOT redirects it
    log_root_dir: Path = dataclasses.field(
        default_factory=lambda: Path(
            os.environ.get("VMTL_LOG_ROOT", str(root_dir / "lightning_logs"))
        )
    )

    def update_fields_with_args(self, args: argparse.Namespace) -> None:
        """Copy the parsed CLI args that name a field of this config (not
        its sections)."""
        for k, v in vars(args).items():
            if k in ("logger", "vis"):
                continue
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
