"""The port's NYUv2 path against the JAX package's on the CPU: its own
binding to the native PNG decoder on PNGs of every filter type, the NYUv2
samples, the prepared-array cache written by either package and read by
the other, a stale cache, the native Cityscapes batch, and the
datamodule's NYUv2 split."""

import os
import struct
import threading
import urllib.request
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from vision_mtl_tpu.cfg import ResizeSpec as JaxResizeSpec
from vision_mtl_tpu.data import datamodule as jax_datamodule
from vision_mtl_tpu.data import loader as jax_loader
from vision_mtl_tpu.data import native as jax_native
from vision_mtl_tpu.data import nyu_cache as jax_nyu_cache
from vision_mtl_tpu.data import nyuv2 as jax_nyuv2
from vision_mtl_tpu.data import transforms as jax_transforms
from vision_mtl_tpu_torch.cfg import ResizeSpec, nyuv2_data_cfg
from vision_mtl_tpu_torch.data import cityscapes, datamodule, loader, native, nyu_cache, nyuv2

SPEC = (32, 32)
HW = (48, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def write_png(path, arr, level=6):
    """A PNG of a uint8 (H, W) or (H, W, 3) array, or a uint16 (H, W) one
    (16-bit big-endian gray), with the standard library alone. Row y takes
    filter type y % 5, so every unfilter path of a decoder runs."""
    arr = np.asarray(arr)
    h, w = arr.shape[:2]
    chans = 1 if arr.ndim == 2 else arr.shape[2]
    depth = 16 if arr.dtype == np.uint16 else 8
    bpp = chans * depth // 8
    raw = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr.astype(np.uint8))
    rows = raw.view(np.uint8).reshape(h, w * bpp).astype(np.int32)
    up = np.vstack([np.zeros_like(rows[:1]), rows[:-1]])
    left = np.hstack([np.zeros_like(rows[:, :bpp]), rows[:, :-bpp]])
    upleft = np.hstack([np.zeros_like(up[:, :bpp]), up[:, :-bpp]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = [0 * rows, left, up, (left + up) // 2, paeth]
    ftype = np.arange(h) % 5
    filtered = (rows - np.choose(ftype[:, None], preds)) & 0xFF
    body = np.hstack([ftype[:, None], filtered]).astype(np.uint8).tobytes()

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    color = {1: 0, 3: 2, 4: 6}[chans]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(body, level)))
        f.write(chunk(b"IEND", b""))


def nyu_arrays(rng, h, w):
    """One seeded triple: 8-bit RGB, ids 0-13 as a function of the pixel
    (so neighbouring ids often differ by one and the bilinear label resize
    meets ties), depth in metres x 1e4 as uint16."""
    rgb = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    seg = ((rgb[..., 0].astype(np.int32) // 16 + rgb[..., 1] // 128) % 14).astype(np.uint8)
    depth = (rng.uniform(0.5, 9.9, size=(h, w)) * 1e4).astype(np.uint16)
    return rgb, seg, depth


def make_tree(root, counts=(("train", 5), ("test", 3)), seed=5):
    rng = np.random.default_rng(seed)
    for stage, n in counts:
        for part in ("rgb", "seg13", "depth"):
            os.makedirs(os.path.join(root, f"{stage}_{part}"), exist_ok=True)
        for i in range(n):
            for part, arr in zip(("rgb", "seg13", "depth"), nyu_arrays(rng, *HW)):
                write_png(os.path.join(root, f"{stage}_{part}", f"{i + 1:04d}.png"), arr)
    return str(root)


@pytest.fixture(scope="module")
def nyu_tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("nyuv2"))


@pytest.mark.parametrize("fmt", ["rgb8", "gray8", "gray16"])
def test_read_png_matches_jax_reader(tmp_path, fmt):
    """The port's binding gives back exactly the written array, as JAX's
    reader and PIL do, through all five filter types (rows cycle them)."""
    rng = np.random.default_rng(len(fmt))
    arr = {"rgb8": lambda: rng.integers(0, 256, (13, 17, 3), dtype=np.uint8),
           "gray8": lambda: rng.integers(0, 256, (13, 17), dtype=np.uint8),
           "gray16": lambda: rng.integers(0, 65536, (13, 17)).astype(np.uint16)}[fmt]()
    path = str(tmp_path / f"{fmt}.png")
    write_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    got = native.read_png(path)
    assert got.dtype == np.float32 and got.shape == arr.shape
    np.testing.assert_array_equal(got, arr.astype(np.float32))
    np.testing.assert_array_equal(got, jax_native.read_png(path))
    with pytest.raises(native.DecodeError, match="decode failed"):
        native.read_png(str(tmp_path / "missing.png"))


def test_native_build_failure_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """No silent fallback: a build that fails raises with what the compiler
    said."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'zlib.h: no such file' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)exited 1.*zlib.h: no such file"):
        native.build()
    assert not any((tmp_path / "build").iterdir())


def _samples(stage, tree, spec):
    """The port's and JAX's datasets over ``tree``, resized to ``spec`` or
    not at all."""
    got = nyuv2.NYUv2(stage=stage, data_base_dir=tree,
                      transforms=spec and ResizeSpec(*spec))
    want = jax_nyuv2.NYUv2(stage=stage, data_base_dir=tree,
                           transforms=spec and JaxResizeSpec(*spec, antialias=True))
    return got, want


@pytest.mark.parametrize("stage", ["train", "test"])
def test_nyuv2_samples_match_jax(nyu_tree, stage):
    """Without a resize, bit for bit. With the 48x64 -> 32x32 resize, images
    and depth within 1e-5 (the two antialiased bilinears sum in another
    order); ids exactly, except where the bilinear label value sits at a
    tie (.5, within 1e-3) that the other sum rounds the other way: such an
    id may differ by 1, and no other id may differ."""
    got_ds, want_ds = _samples(stage, nyu_tree, None)
    assert len(got_ds) == len(want_ds) == (5 if stage == "train" else 3)
    assert got_ds.filenames == want_ds.filenames
    for i in range(len(want_ds)):
        g, w = got_ds[i], want_ds[i]
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    got_ds, want_ds = _samples(stage, nyu_tree, SPEC)
    ties = 0
    for i in range(len(want_ds)):
        g, w = got_ds[i], want_ds[i]
        assert g["img"].shape == (*SPEC, 3) and g["depth"].shape == (*SPEC, 1)
        np.testing.assert_allclose(g["img"], w["img"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["depth"], w["depth"], rtol=0, atol=1e-5)
        assert g["mask"].dtype == w["mask"].dtype == np.int32
        raw = want_ds.load_raw_sample(i)["mask"].astype(np.float32) / 255.0
        pre = jax_transforms.resize_mask(raw, JaxResizeSpec(*SPEC), bilinear=True) * 255.0
        differ = g["mask"] != w["mask"]
        ties += int(differ.sum())
        assert (np.abs(g["mask"] - w["mask"])[differ] == 1).all()
        assert (np.abs(pre[differ] % 1.0 - 0.5) < 1e-3).all(), pre[differ]
    print(f"NYUv2 {stage}: {ties} ids differ, each at a tie")
    # the tree's ids meet at ties: the check above has cases to check
    n_ties = sum(
        int((np.abs(jax_transforms.resize_mask(
            want_ds.load_raw_sample(i)["mask"].astype(np.float32) / 255.0,
            JaxResizeSpec(*SPEC), bilinear=True) * 255.0 % 1.0 - 0.5) < 1e-3).sum())
        for i in range(len(want_ds))
    )
    assert n_ties > 0


def test_cache_crosses_between_packages(nyu_tree, tmp_path):
    """A cache JAX wrote is valid for the port and reads back the same
    arrays; one the port wrote is valid for JAX and reads back the same;
    the loader serves batches from it."""
    spec = ResizeSpec(*SPEC)
    for writer in ("jax", "port"):
        root = make_tree(tmp_path / writer, counts=(("train", 4), ("test", 1)), seed=7)
        want_ds = jax_nyuv2.NYUv2(stage="train", data_base_dir=root,
                                  transforms=JaxResizeSpec(*SPEC, antialias=True))
        got_ds = nyuv2.NYUv2(stage="train", data_base_dir=root, transforms=spec)
        assert got_ds.load_batch([0]) is None  # no cache yet
        cdir = (jax_nyu_cache if writer == "jax" else nyu_cache).build_cache(
            want_ds if writer == "jax" else got_ds)
        assert cdir == nyu_cache.cache_dir_for(got_ds) == jax_nyu_cache.cache_dir_for(want_ds)
        assert cdir.endswith(os.path.join("_cache", "train_32x32_v1"))
        assert nyu_cache.cache_valid(got_ds) and jax_nyu_cache.cache_valid(want_ds)
        # a dataset that found no cache looks again only after its own
        # package's build: a fresh one opens the other package's cache
        got_ds = nyuv2.NYUv2(stage="train", data_base_dir=root, transforms=spec)
        got, want = nyu_cache.open_cache(got_ds), jax_nyu_cache.open_cache(want_ds)
        for k in ("img", "mask", "depth"):
            assert got[k].dtype == want[k].dtype and got[k].shape[0] == 4
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        order = [3, 0, 2]
        g, w = got_ds.load_batch(order), want_ds.load_batch(order)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        if writer == "port":
            # the cache holds the per-sample path's output, bit for bit
            for j, i in enumerate(order):
                s = got_ds[i]
                for k in s:
                    np.testing.assert_array_equal(g[k][j], s[k], err_msg=k)
            batches = list(loader.DataLoader(got_ds, batch_size=2, shuffle=True, seed=1))
            want_batches = list(jax_loader.DataLoader(want_ds, batch_size=2, shuffle=True,
                                                          seed=1))
            assert len(batches) == len(want_batches) == 2
            for b, wb in zip(batches, want_batches):
                for k in wb:
                    np.testing.assert_array_equal(b[k], wb[k], err_msg=k)


def test_stale_cache_rejected(tmp_path, monkeypatch):
    """A PNG rewritten in place, another max_depth or another file list
    makes the cache stale for both packages; the environment switch builds
    a cache at construction, and concurrent builders leave one valid
    cache."""
    root = make_tree(tmp_path / "t", counts=(("train", 3), ("test", 1)), seed=9)
    spec = ResizeSpec(*SPEC)
    monkeypatch.setenv("VMTL_BUILD_NYU_CACHE", "1")
    ds = nyuv2.NYUv2(stage="train", data_base_dir=root, transforms=spec)
    monkeypatch.delenv("VMTL_BUILD_NYU_CACHE")
    jds = jax_nyuv2.NYUv2(stage="train", data_base_dir=root,
                          transforms=JaxResizeSpec(*SPEC, antialias=True))
    assert nyu_cache.cache_valid(ds) and jax_nyu_cache.cache_valid(jds)
    assert not nyu_cache.cache_valid(nyuv2.NYUv2(stage="train", data_base_dir=root,
                                                 transforms=spec, max_depth=5.0))
    path = os.path.join(root, "train_rgb", "0002.png")
    write_png(path, np.zeros((*HW, 3), np.uint8), level=1)
    assert not nyu_cache.cache_valid(ds) and not jax_nyu_cache.cache_valid(jds)
    assert nyu_cache.open_cache(ds) is None
    os.remove(os.path.join(root, "train_seg13", "0003.png"))
    assert not nyu_cache.cache_valid(ds)
    write_png(os.path.join(root, "train_seg13", "0003.png"), np.ones(HW, np.uint8))

    threads = [threading.Thread(target=nyu_cache.build_cache,
                                args=(nyuv2.NYUv2(stage="train", data_base_dir=root,
                                                  transforms=spec),))
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert nyu_cache.cache_valid(ds) and jax_nyu_cache.cache_valid(jds)
    np.testing.assert_array_equal(ds.load_batch([1])["img"][0], ds[1]["img"])
    assert ds.load_batch([1])["img"][0].max() == 0.0
    assert not [f for f in os.listdir(nyu_cache.cache_dir_for(ds)) if f.endswith(".tmp")]


def test_native_cityscapes_batch_matches_jax(tmp_path):
    """The port's native batch equals JAX's native batch bit for bit (the
    same C++), at a 2x downscale and at the identity. Against the
    per-sample path, as tests/test_native.py holds JAX's: at the identity
    size equal (images within 1e-6 relative), and at the downscale the
    native nearest takes the even pixels (PIL's nearest takes the odd
    ones)."""
    rng = np.random.default_rng(4)
    for sub in ("image", "label", "depth"):
        (tmp_path / "train" / sub).mkdir(parents=True)
    for i in range(3):
        np.save(tmp_path / "train" / "image" / f"{i}.npy",
                rng.uniform(0, 1, (32, 48, 3)).astype(np.float32))
        np.save(tmp_path / "train" / "label" / f"{i}.npy",
                rng.integers(-1, 19, (32, 48)).astype(np.int64))
        np.save(tmp_path / "train" / "depth" / f"{i}.npy",
                rng.uniform(0, 1, (32, 48)).astype(np.float32))
    idxs = [2, 0, 1]
    for size in ((16, 24), (32, 48)):
        ds = cityscapes.CityscapesDataset("train", data_base_dir=str(tmp_path),
                                          transforms=ResizeSpec(*size))
        got = ds.load_batch(idxs)
        want = jax_native.load_cityscapes_batch(
            [ds.paths["img"][i] for i in idxs], [ds.paths["mask"][i] for i in idxs],
            [ds.paths["depth"][i] for i in idxs], *size)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape[:3] == (3, *size)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for j, i in enumerate(idxs):
            if size == (32, 48):
                s = ds[i]
                np.testing.assert_array_equal(got["mask"][j], s["mask"])
                np.testing.assert_array_equal(got["depth"][j], s["depth"])
                np.testing.assert_allclose(got["img"][j], s["img"], rtol=1e-6)
            else:
                mask = np.load(ds.paths["mask"][i])[::2, ::2]
                np.testing.assert_array_equal(got["mask"][j], np.where(mask == -1, 18, mask))
                np.testing.assert_array_equal(got["depth"][j, ..., 0],
                                              np.load(ds.paths["depth"][i])[::2, ::2])
    with pytest.raises(native.DecodeError, match="sample 0"):
        native.load_cityscapes_batch(["/nonexistent.npy"], [ds.paths["mask"][0]],
                                     [ds.paths["depth"][0]], 4, 4)


def test_datamodule_nyuv2_matches_jax(nyu_tree, monkeypatch):
    """``MTLDataModule("nyuv2")``: the same split, the holdout on the
    'test' stage, the benchmark ids past a small tree reported, and every
    loader's batches equal (no resize: bit for bit)."""
    monkeypatch.setattr(nyuv2_data_cfg, "data_dir", nyu_tree)
    monkeypatch.setattr(jax_nyuv2.data_cfg, "data_dir", nyu_tree)
    kw = dict(dataset_name="nyuv2", batch_size=2, seed=3, train_transform=None,
              test_transform=None)
    want, got = jax_datamodule.MTLDataModule(**kw), datamodule.MTLDataModule(**kw)
    want.setup()
    got.setup()
    assert got.wire_format == want.wire_format == "f32"
    assert got.benchmark_batch is None and want.benchmark_batch is None
    assert list(got.data_train.indices) == list(want.data_train.indices)
    assert list(got.data_val.indices) == list(want.data_val.indices)
    assert got.data_predict.stage == got.data_test.stage == "test"
    for make in ("train_dataloader", "val_dataloader", "predict_dataloader"):
        g_all, w_all = list(getattr(got, make)()), list(getattr(want, make)())
        assert len(g_all) == len(w_all) > 0
        for g, w in zip(g_all, w_all):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{make} {k}")
    for dm in (datamodule, jax_datamodule):
        assert type(dm._make_dataset("nyuv2", "test", None)).__name__ == "NYUv2"
    # the config: 14 classes, 256x256 transforms, max_depth 10, the f32 wire
    jcfg = jax_nyuv2.data_cfg
    for k in ("num_classes", "class_names", "max_depth", "height", "width", "batch_size",
              "num_workers", "shuffle_train", "train_size", "wire_format"):
        assert getattr(nyuv2_data_cfg, k) == getattr(jcfg, k), k
    for k in ("train_transform", "test_transform"):
        got, want = getattr(nyuv2_data_cfg, k), getattr(jcfg, k)
        assert (got.height, got.width) == (want.height, want.width) == (256, 256)
    assert nyuv2_data_cfg.num_classes == 14 and nyuv2_data_cfg.max_depth == 10.0


def _offline(url, dst):
    raise OSError("network is unreachable")


def test_nyuv2_missing_tree_and_download(tmp_path, nyu_tree, monkeypatch):
    with pytest.raises(RuntimeError, match="Dataset not complete"):
        nyuv2.NYUv2(stage="train", data_base_dir=str(tmp_path))
    # no archive and no network: download names where to put the archive
    monkeypatch.setattr(urllib.request, "urlretrieve", _offline)
    with pytest.raises(RuntimeError, match=r"Could not download .*Place the archive at"):
        nyuv2.NYUv2(stage="train", data_base_dir=str(tmp_path), download=True)
    assert len(nyuv2.NYUv2(stage="test", data_base_dir=nyu_tree, download=True)) == 3
    with pytest.raises(ValueError, match="train or test"):
        nyuv2.NYUv2(stage="val", data_base_dir=nyu_tree)
