"""Cityscapes MTL dataset over pre-processed ``.npy`` triples (counterpart of
``vision_mtl_tpu/data/cityscapes.py``).

Layout ``{data_dir}/{stage}/{image,label,depth}/*.npy``: images in [0, 1],
labels with the ignore id -1 folded into ``num_classes - 1``, inverse depth
in [0, 1]. Resize: bilinear for images, nearest for masks and depth.
``load_batch`` decodes a whole batch through the native C++ path
(``data/native.py``), which the loader takes over the per-sample one.
"""

from __future__ import annotations

import glob
import typing as t

import numpy as np

from vision_mtl_tpu_torch.cfg import cityscapes_data_cfg as data_cfg
from vision_mtl_tpu_torch.data.base import UNSET, MTLDataset, Sample
from vision_mtl_tpu_torch.data.transforms import resize_depth, resize_image, resize_mask


class CityscapesDataset(MTLDataset):
    benchmark_idxs: t.List[int] = [955, 2279, 1878, 2325]

    def __init__(
        self,
        stage: str,
        data_base_dir: t.Optional[str] = None,
        transforms: t.Any = UNSET,
        max_depth: t.Optional[float] = None,
    ):
        # the config is read here, not at import, so a CLI-pointed data dir
        # takes effect; an explicit `transforms` (None included) applies to
        # both stages, the default binds each stage to its own config field
        super().__init__(
            stage=stage,
            data_base_dir=data_base_dir if data_base_dir is not None else data_cfg.data_dir,
            max_depth=max_depth if max_depth is not None else data_cfg.max_depth,
            train_transform=data_cfg.train_transform if transforms is UNSET else transforms,
            test_transform=data_cfg.test_transform if transforms is UNSET else transforms,
        )
        self.paths = self.parse_paths()

    def __len__(self) -> int:
        return len(self.paths["img"])

    def parse_paths(self) -> t.Dict[str, t.List[str]]:
        base_dir = f"{self.data_base_dir}/{self.stage}"
        dir_name_to_key = {"image": "img", "label": "mask", "depth": "depth"}
        paths = {
            v: sorted(glob.glob(f"{base_dir}/{k}/*.npy")) for k, v in dir_name_to_key.items()
        }
        if not paths["img"]:
            raise FileNotFoundError(
                f"No cityscapes npy files under {base_dir}/image — expected "
                f"the preprocessed Kaggle layout "
                f"{{data_dir}}/{{stage}}/{{image,label,depth}}/*.npy "
                f"(see README 'Data layout')."
            )
        counts = {k: len(v) for k, v in paths.items()}
        if len(set(counts.values())) != 1:
            raise ValueError(f"unequal numbers of image, label and depth files: {counts}")
        return paths

    def load_batch(self, idxs: t.Sequence[int]) -> Sample:
        """Native batched decode, resize and collate. Without a transform it
        resizes to the config's size, as the JAX package's does; the resize
        is the identity for trees already at that size, where the batch
        equals the per-sample path's bit for bit."""
        from vision_mtl_tpu_torch.data import native

        spec = self.transform
        return native.load_cityscapes_batch(
            [self.paths["img"][i] for i in idxs],
            [self.paths["mask"][i] for i in idxs],
            [self.paths["depth"][i] for i in idxs],
            spec.height if spec else data_cfg.height,
            spec.width if spec else data_cfg.width,
            ignore_value=-1,
            remap_to=data_cfg.num_classes - 1,
            depth_div=1.0,
        )

    def load_raw_sample(self, idx: int) -> Sample:
        img = np.load(self.paths["img"][idx])
        if not img.max() <= 1.0:
            raise ValueError(f"{self.paths['img'][idx]}: image values exceed 1")
        mask = np.load(self.paths["mask"][idx])
        depth = np.load(self.paths["depth"][idx])
        return {"img": img, "mask": mask, "depth": depth}

    def prepare_sample(self, raw_sample: Sample, transform: t.Any = None) -> Sample:
        img = raw_sample["img"]
        mask = raw_sample["mask"].copy()
        depth = raw_sample["depth"]

        mask[mask == -1] = data_cfg.num_classes - 1  # the ignore id's fold

        if transform is not None:
            img = resize_image(img, transform)
            mask = resize_mask(mask, transform)
            depth = resize_depth(depth, transform)

        img = img.astype(np.float32)
        mask = mask.astype(np.int32)
        depth = self.normalize_depth(depth.astype(np.float32))
        if depth.ndim == 2:
            depth = depth[..., None]
        return {"img": img, "mask": mask, "depth": depth}
