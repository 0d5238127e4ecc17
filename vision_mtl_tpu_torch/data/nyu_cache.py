"""The prepared-array cache of NYUv2 (counterpart of
``vision_mtl_tpu/data/nyu_cache.py``, with its on-disk layout, so a cache
either package wrote is accepted, or rejected as stale, by the other).

Decoding NYUv2's PNGs costs far more host time than a step takes on the
device, so every sample is decoded once through the per-sample path
(``NYUv2.load_raw_sample`` and ``prepare_sample``, every quirk included)
and the prepared arrays are written to flat ``.npy`` files:

    {data_dir}/_cache/{stage}_{H}x{W}_v1/
        img.npy    (N, H, W, 3) float32
        mask.npy   (N, H, W)    uint8, int32 on read (ids are 0..255)
        depth.npy  (N, H, W, 1) float32
        meta.json  {version, n, height, width, max_depth, filenames_sha1,
                    source_sig}

``source_sig`` hashes each source PNG's size and mtime, so a tree rewritten
in place with the same names invalidates the cache. Build with
``build_cache(dataset)`` or ``VMTL_BUILD_NYU_CACHE=1`` at dataset
construction.
"""

from __future__ import annotations

import hashlib
import json
import os
import typing as t

import numpy as np

from vision_mtl_tpu_torch.utils.io import atomic_write_json, file_lock

CACHE_VERSION = 1
KEYS = ("img", "mask", "depth")


def _filenames_sha1(filenames: t.Sequence[str]) -> str:
    h = hashlib.sha1()
    for fn in filenames:
        h.update(fn.encode())
        h.update(b"\0")
    return h.hexdigest()


def _source_sig(ds: t.Any) -> str:
    """Size and mtime of every source PNG of the dataset's stage, hashed
    (stats only, no reads)."""
    h = hashlib.sha1()
    parts = ["rgb", "seg13", "depth"] + (["sn"] if getattr(ds, "use_sn", False) else [])
    for part in parts:
        d = os.path.join(ds.data_base_dir, f"{ds.stage}_{part}")
        for fn in ds.filenames:
            try:
                st = os.stat(os.path.join(d, fn))
                h.update(f"{part}/{fn}:{st.st_size}:{st.st_mtime_ns}".encode())
            except OSError:
                h.update(f"{part}/{fn}:missing".encode())
    return h.hexdigest()


def cache_dir_for(ds: t.Any) -> str:
    spec = ds.transform
    tag = f"{spec.height}x{spec.width}" if spec is not None else "raw"
    return os.path.join(ds.data_base_dir, "_cache", f"{ds.stage}_{tag}_v{CACHE_VERSION}")


def _expected_meta(ds: t.Any) -> t.Dict[str, t.Any]:
    return {
        "version": CACHE_VERSION,
        "n": len(ds),
        "max_depth": float(ds.max_depth),
        "filenames_sha1": _filenames_sha1(ds.filenames),
        "source_sig": _source_sig(ds),
    }


def build_cache(ds: t.Any, force: bool = False) -> str:
    """Decode every sample through the per-sample path and write the
    prepared arrays; returns the cache directory. A valid cache is kept
    unless ``force``. Concurrent builders (several processes or threads
    constructing the dataset) are serialised by an ``flock``: two writers
    would truncate each other's files, and torn arrays would still pass the
    metadata check."""
    cdir = cache_dir_for(ds)
    if not force and cache_valid(ds):
        return cdir
    os.makedirs(cdir, exist_ok=True)
    with file_lock(os.path.join(cdir, ".build.lock")):
        # a builder that held the lock meanwhile may have finished
        if not force and cache_valid(ds):
            return cdir
        _write(ds, cdir)
    # a dataset that already found no cache looks again at its next batch
    if hasattr(ds, "_cache_checked"):
        ds._cache_checked = False
        ds._cache = None
    return cdir


def _write(ds: t.Any, cdir: str) -> None:
    first = ds.prepare_sample(ds.load_raw_sample(0), ds.transform)
    n = len(ds)
    shapes = {k: first[k].shape for k in KEYS}
    dtypes = {"img": np.float32, "mask": np.uint8, "depth": np.float32}
    # temporary names, renamed after the full pass, and meta.json last: a
    # crashed build is never taken for a complete cache
    mm = {
        k: np.lib.format.open_memmap(
            os.path.join(cdir, f"{k}.npy.tmp"), mode="w+", dtype=dtypes[k], shape=(n,) + shapes[k]
        )
        for k in KEYS
    }
    for i in range(n):
        sample = first if i == 0 else ds.prepare_sample(ds.load_raw_sample(i), ds.transform)
        mask = sample["mask"]
        if mask.min() < 0 or mask.max() > 255:
            raise ValueError(
                f"sample {i}: label ids outside 0..255; the cache stores them as uint8"
            )
        mm["img"][i] = sample["img"]
        mm["mask"][i] = mask.astype(np.uint8)
        mm["depth"][i] = sample["depth"]
    for arr in mm.values():
        arr.flush()
    mm.clear()
    for k in KEYS:
        os.replace(os.path.join(cdir, f"{k}.npy.tmp"), os.path.join(cdir, f"{k}.npy"))
    atomic_write_json(os.path.join(cdir, "meta.json"), {
        **_expected_meta(ds), "height": int(shapes["img"][0]), "width": int(shapes["img"][1])
    })


def cache_valid(ds: t.Any) -> bool:
    """Whether a cache for the dataset's stage, transform, max_depth, file
    list and source files exists; reads meta.json only."""
    cdir = cache_dir_for(ds)
    try:
        with open(os.path.join(cdir, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return False
    if any(meta.get(k) != v for k, v in _expected_meta(ds).items()):
        return False
    return all(os.path.exists(os.path.join(cdir, f"{k}.npy")) for k in KEYS)


def open_cache(ds: t.Any) -> t.Optional[t.Dict[str, np.ndarray]]:
    """The cache's arrays, memory-mapped; None when it is absent or stale."""
    if not cache_valid(ds):
        return None
    cdir = cache_dir_for(ds)
    try:
        return {k: np.load(os.path.join(cdir, f"{k}.npy"), mmap_mode="r") for k in KEYS}
    except (OSError, ValueError):
        return None
