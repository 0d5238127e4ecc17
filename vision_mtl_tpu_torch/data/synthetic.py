"""Synthetic MTL dataset: deterministic, learnable, needs no files on disk
(counterpart of ``vision_mtl_tpu/data/synthetic.py``, sample for sample).

Each sample comes from its own numpy generator: the image is a smoothed
random field, the mask the argmax of a fixed random projection of it, and
the depth a bounded function of its channels.
"""

from __future__ import annotations

import dataclasses
import typing as t

import numpy as np

from vision_mtl_tpu_torch.cfg import DataConfig, ResizeSpec
from vision_mtl_tpu_torch.data.base import MTLDataset, Sample


@dataclasses.dataclass
class SyntheticConfig(DataConfig):
    dataset_name: str = "synthetic"
    height: int = 64
    width: int = 64
    num_classes: int = 7
    class_names: t.List[str] = dataclasses.field(
        default_factory=lambda: [f"class_{i}" for i in range(7)]
    )
    max_depth: float = 1.0
    batch_size: int = 4
    num_train: int = 64
    num_val: int = 16
    train_transform: t.Optional[ResizeSpec] = None
    test_transform: t.Optional[ResizeSpec] = None


synthetic_data_cfg = SyntheticConfig()


def _smooth(field: np.ndarray, k: int = 9) -> np.ndarray:
    """Separable box smoothing with circular edges."""
    out = field
    for axis in (0, 1):
        acc = np.zeros_like(out)
        for s in range(-(k // 2), k // 2 + 1):
            acc += np.roll(out, s, axis=axis)
        out = acc / float(k)
    return out


class SyntheticMTLDataset(MTLDataset):
    benchmark_idxs: t.List[int] = [0, 1, 2, 3]

    def __init__(
        self,
        stage: str = "train",
        data_base_dir: str = "",
        transforms: t.Any = None,
        max_depth: float = 1.0,
        cfg: SyntheticConfig = synthetic_data_cfg,
    ):
        super().__init__(
            stage=stage,
            data_base_dir=data_base_dir,
            max_depth=max_depth,
            train_transform=transforms,
            test_transform=transforms,
        )
        self.cfg = cfg
        self.length = cfg.num_train if stage == "train" else cfg.num_val
        self.offset = 0 if stage == "train" else 100_000
        # the fixed projection that defines the labels
        self.proj = np.random.default_rng(7).normal(size=(3, cfg.num_classes)).astype(np.float32)

    def __len__(self) -> int:
        return self.length

    def load_raw_sample(self, idx: int) -> Sample:
        rng = np.random.default_rng(self.offset + idx)
        h, w = self.cfg.height, self.cfg.width
        img = _smooth(rng.normal(size=(h, w, 3)).astype(np.float32))
        img = (img - img.min()) / max(float(np.ptp(img)), 1e-6)
        mask = np.argmax(img @ self.proj, axis=-1).astype(np.int64)
        depth = 1.0 / (1.0 + np.exp(-(img[..., 0] - img[..., 2])))
        return {"img": img, "mask": mask, "depth": depth.astype(np.float32)}

    def prepare_sample(self, raw_sample: Sample, transform: t.Any = None) -> Sample:
        img = raw_sample["img"].astype(np.float32)
        mask = raw_sample["mask"].astype(np.int32)
        depth = self.normalize_depth(raw_sample["depth"].astype(np.float32))
        if depth.ndim == 2:
            depth = depth[..., None]
        return {"img": img, "mask": mask, "depth": depth}
