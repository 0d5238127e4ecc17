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

``download`` builds the tree from the reference's four published archives
(the RGB and 13-class label ``.tgz`` files, the surface-normal ``.zip``,
the labelled depth ``.mat``), as the JAX package does: an archive already
in the root is used as it is, without the network; a missing one is
fetched with ``urllib`` and, where that fails, named in a RuntimeError
that says where to put it. The ``.mat`` is read with ``h5py`` (imported by
the one function that reads it), and each depth map is written as a
16-bit gray PNG (metres x 1e4) with ``zlib``, since the port has no PIL:
the same pixels PIL writes, read back the same by PIL and by the port's
decoder.
"""

from __future__ import annotations

import os
import shutil
import struct
import tarfile
import typing as t
import urllib.request
import zipfile
import zlib

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
        """Build the missing folders from the archives (see the module
        docstring); a complete tree needs nothing."""
        if self._check_exists():
            return
        os.makedirs(self.data_base_dir, exist_ok=True)
        download_rgb(self.data_base_dir)
        download_seg(self.data_base_dir)
        download_depth(self.data_base_dir)
        if self.use_sn:
            download_sn(self.data_base_dir)
        print("Done!")


def _fetch(url: str, root: str) -> str:
    """The archive of ``url`` in ``root``: the file already there, or
    downloaded; a failed download raises, naming where to put it."""
    dst = os.path.join(root, url.split("/")[-1].split("?")[0])
    if os.path.exists(dst):
        return dst
    try:
        urllib.request.urlretrieve(url, dst)
    except Exception as e:
        raise RuntimeError(
            f"Could not download {url} (no network egress?). Place the "
            f"archive at {dst} manually and re-run."
        ) from e
    return dst


def _unpack(file: str) -> None:
    """Extract a ``.tgz`` or ``.zip`` beside it, into its name without the
    extension."""
    path = file.rsplit(".", 1)[0]
    if file.endswith(".tgz"):
        with tarfile.open(file, "r:gz") as tar:
            tar.extractall(path, filter="data")
    elif file.endswith(".zip"):
        with zipfile.ZipFile(file, "r") as zf:
            zf.extractall(path)


def _rename_files(folder: str, rename_func: t.Callable[[str], str]) -> None:
    for old in os.listdir(folder):
        shutil.move(os.path.join(folder, old), os.path.join(folder, rename_func(old)))


def _replace_folder(src: str, dst: str) -> None:
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.move(src, dst)


def download_rgb(root: str) -> None:
    train_url = "http://www.doc.ic.ac.uk/~ahanda/nyu_train_rgb.tgz"
    test_url = "http://www.doc.ic.ac.uk/~ahanda/nyu_test_rgb.tgz"

    def _proc(url: str, dst: str) -> None:
        if os.path.exists(dst):
            return
        tar = _fetch(url, root)
        _unpack(tar)
        # str.rstrip strips characters, not the suffix: kept as the
        # reference has it
        _replace_folder(tar.rstrip(".tgz"), dst)
        _rename_files(dst, lambda x: x.split("_")[2])

    _proc(train_url, os.path.join(root, "train_rgb"))
    _proc(test_url, os.path.join(root, "test_rgb"))


def download_seg(root: str) -> None:
    base = "https://github.com/ankurhanda/nyuv2-meta-data/raw/master"
    train_url = f"{base}/train_labels_13/nyuv2_train_class13.tgz"
    test_url = f"{base}/test_labels_13/nyuv2_test_class13.tgz"

    def _proc(url: str, dst: str) -> None:
        if os.path.exists(dst):
            return
        tar = _fetch(url, root)
        _unpack(tar)
        _replace_folder(tar.rstrip(".tgz"), dst)
        _rename_files(dst, lambda x: x.split("_")[3])

    _proc(train_url, os.path.join(root, "train_seg13"))
    _proc(test_url, os.path.join(root, "test_seg13"))


def download_sn(root: str) -> None:
    url = "https://www.dropbox.com/s/dn5sxhlgml78l03/nyu_normals_gt.zip?dl=1"
    train_dst = os.path.join(root, "train_sn")
    test_dst = os.path.join(root, "test_sn")
    if os.path.exists(train_dst) and os.path.exists(test_dst):
        return
    tar = _fetch(url, root)
    _unpack(tar)
    if not os.path.exists(train_dst):
        _replace_folder(os.path.join(root, "nyu_normals_gt", "train"), train_dst)
        _rename_files(train_dst, lambda x: x[1:])
    if not os.path.exists(test_dst):
        _replace_folder(os.path.join(root, "nyu_normals_gt", "test"), test_dst)
        _rename_files(test_dst, lambda x: x[1:])
    shutil.rmtree(os.path.join(root, "nyu_normals_gt"), ignore_errors=True)


def download_depth(
    root: str,
    url: str = "http://horatio.cs.nyu.edu/mit/silberman/nyu_depth_v2/nyu_depth_v2_labeled.mat",
) -> None:
    """Per-image uint16 depth PNGs (metres x 1e4) from the labelled
    dataset's ``.mat``; images whose id names a ``train_rgb`` file go to
    ``train_depth``, the others to ``test_depth``."""
    train_dst = os.path.join(root, "train_depth")
    test_dst = os.path.join(root, "test_depth")
    if os.path.exists(train_dst) and os.path.exists(test_dst):
        return
    mat = _fetch(url, root)
    train_ids = {f.split(".")[0] for f in os.listdir(os.path.join(root, "train_rgb"))}
    _create_depth_files(mat, root, train_ids)


def _create_depth_files(mat_file: str, root: str, train_ids: t.Set[str]) -> None:
    import h5py

    os.makedirs(os.path.join(root, "train_depth"), exist_ok=True)
    os.makedirs(os.path.join(root, "test_depth"), exist_ok=True)
    with h5py.File(mat_file, "r") as f:
        depths = f["depths"]
        for i in range(len(depths)):
            img = (depths[i] * 1e4).astype(np.uint16).T
            id_ = str(i + 1).zfill(4)
            folder = "train" if id_ in train_ids else "test"
            write_png16(os.path.join(root, f"{folder}_depth", id_ + ".png"), img)


def write_png16(path: str, img: np.ndarray) -> None:
    """A (H, W) uint16 array as a 16-bit gray PNG (big-endian samples, no
    filtering, one zlib stream), with the standard library alone."""
    if img.dtype != np.uint16 or img.ndim != 2:
        raise ValueError(f"write_png16 takes a 2-D uint16 array, got {img.dtype} {img.shape}")
    h, w = img.shape
    rows = np.ascontiguousarray(img.astype(">u2")).view(np.uint8).reshape(h, 2 * w)
    body = np.hstack([np.zeros((h, 1), np.uint8), rows]).tobytes()  # filter 0 per row

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(body, 6)))
        f.write(chunk(b"IEND", b""))
