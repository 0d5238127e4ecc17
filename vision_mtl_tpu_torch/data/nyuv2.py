"""NYUv2 MTL dataset: 13 classes and a background id, and depth
(counterpart of ``vision_mtl_tpu/data/nyuv2.py``).

PNG folders ``{stage}_{rgb,seg13,depth[,sn]}`` share file names. Every PNG
goes through the native zlib decoder (``data/native.py``); the port has no
PIL path. ``prepare_sample`` keeps the reference's quirks: images are
divided by 255; the label map is divided by 255, resized with the same
antialiased bilinear as the image, multiplied by 255 again when its values
are at most 1, and rounded; depth PNGs hold metres x 1e4 in uint16 and are
divided by 1e4, then by ``max_depth``; every stream is resized to the
transform's size. ``load_batch`` serves prepared batches from the cache
(``data/nyu_cache.py``) when a valid one exists.

Fetching and extracting the published archives needs the network and
``h5py``; it waits in ROADMAP.md A11, so ``download=True`` on an
incomplete tree raises.
"""

from __future__ import annotations

import os
import typing as t

import numpy as np

from vision_mtl_tpu_torch.cfg import nyuv2_data_cfg as data_cfg
from vision_mtl_tpu_torch.data import native
from vision_mtl_tpu_torch.data.base import UNSET, MTLDataset, Sample
from vision_mtl_tpu_torch.data.transforms import resize_depth, resize_image, resize_mask


class NYUv2(MTLDataset):
    benchmark_idxs: t.List[int] = [647, 584, 169, 768]

    def __init__(
        self,
        stage: str = "train",
        data_base_dir: t.Optional[str] = None,
        download: bool = False,
        use_sn: bool = False,
        transforms: t.Any = UNSET,
        max_depth: t.Optional[float] = None,
    ):
        if stage not in ("train", "test"):
            raise ValueError("stage must be either train or test")
        # the config is read here, not at import, so a CLI-pointed data dir
        # takes effect; an explicit `transforms` (None included) applies to
        # both stages, the default binds each stage to its own config field
        if data_base_dir is None:
            data_base_dir = data_cfg.data_dir
        super().__init__(
            stage=stage,
            data_base_dir=data_base_dir,
            max_depth=max_depth if max_depth is not None else data_cfg.max_depth,
            train_transform=data_cfg.train_transform if transforms is UNSET else transforms,
            test_transform=data_cfg.test_transform if transforms is UNSET else transforms,
        )
        self.use_sn = use_sn

        if download:
            self.download()
        if not self._check_exists():
            raise RuntimeError("Dataset not complete. You can use download=True to download it")

        self.filenames = sorted(os.listdir(os.path.join(data_base_dir, f"{self.stage}_rgb")))

        # the prepared-array cache, opened at the first load_batch
        self._cache: t.Optional[t.Dict[str, np.ndarray]] = None
        self._cache_checked = False
        if os.environ.get("VMTL_BUILD_NYU_CACHE") == "1" and not use_sn:
            from vision_mtl_tpu_torch.data.nyu_cache import build_cache

            build_cache(self)

    def __len__(self) -> int:
        return len(self.filenames)

    def load_batch(self, idxs: t.Sequence[int]) -> t.Optional[Sample]:
        """A batch gathered from the cache, equal to the per-sample path's
        (the cache holds its output); None without a valid cache or with
        surface normals, which are not cached."""
        if self.use_sn:
            return None
        if not self._cache_checked:
            from vision_mtl_tpu_torch.data.nyu_cache import open_cache

            self._cache = open_cache(self)
            self._cache_checked = True
        if self._cache is None:
            return None
        order = np.asarray(idxs, np.int64)
        return {
            "img": np.asarray(self._cache["img"][order]),
            "mask": self._cache["mask"][order].astype(np.int32),
            "depth": np.asarray(self._cache["depth"][order]),
        }

    def _folder(self, name: str) -> str:
        return os.path.join(self.data_base_dir, f"{self.stage}_{name}")

    def load_raw_sample(self, idx: int) -> Sample:
        fn = self.filenames[idx]

        def read(folder: str) -> np.ndarray:
            return native.read_png(os.path.join(self._folder(folder), fn))

        sample: Sample = {"img": read("rgb"), "mask": read("seg13"), "depth": read("depth")}
        if self.use_sn:
            sample["normals"] = read("sn")
        return sample

    def prepare_sample(self, raw_sample: Sample, transform: t.Any = None) -> Sample:
        img = raw_sample["img"].astype(np.float32)
        mask = raw_sample["mask"].astype(np.float32)
        depth = raw_sample["depth"].astype(np.float32)
        normals = raw_sample.get("normals")

        # ToTensor's scaling of 8-bit PNGs, then the antialiased bilinear
        # resize of every stream, the label map included
        if img.max() > 1.0:
            img = img / 255.0
        mask = mask / 255.0
        if transform is not None:
            img = resize_image(img, transform)
            mask = resize_mask(mask, transform, bilinear=True)
            depth = resize_depth(depth, transform, bilinear=True)
            if normals is not None:
                normals = resize_image(normals.astype(np.float32) / 255.0, transform)

        # the reference's un-scaling of the label map
        if mask.max() <= 1.0:
            mask = mask * 255.0
        mask = np.round(mask).astype(np.int32)

        depth = depth.astype(np.float32) / 1e4  # uint16 PNG: metres x 1e4
        depth = self.normalize_depth(depth)
        if depth.ndim == 2:
            depth = depth[..., None]

        sample: Sample = {"img": img.astype(np.float32), "mask": mask, "depth": depth}
        if normals is not None:
            sample["normals"] = normals.astype(np.float32)
        return sample

    def _check_exists(self) -> bool:
        parts = ["rgb", "seg13", "depth"] + (["sn"] if self.use_sn else [])
        return all(
            os.path.exists(os.path.join(self.data_base_dir, f"{split}_{part}"))
            for split in ("train", "test")
            for part in parts
        )

    def download(self) -> None:
        """A complete tree needs nothing; an incomplete one cannot be
        fetched by the port yet."""
        if self._check_exists():
            return
        raise RuntimeError(
            f"NYUv2 is incomplete under {self.data_base_dir}, and fetching and "
            "extracting its archives is not ported to vision_mtl_tpu_torch yet: "
            "ROADMAP.md A11"
        )
