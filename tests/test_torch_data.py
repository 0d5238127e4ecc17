"""The port's data pipeline against the JAX package's on the CPU: synthetic
samples, a Cityscapes-layout tree, the loader's batches over epochs, the
datamodule's split, the resizes against PIL, and ``prefetch_to_device``."""

import numpy as np
import pytest
import torch
from PIL import Image

from vision_mtl_tpu.cfg import ResizeSpec as JaxResizeSpec
from vision_mtl_tpu.cfg import cityscapes_data_cfg as jax_cityscapes_cfg
from vision_mtl_tpu.data import cityscapes as jax_cityscapes
from vision_mtl_tpu.data import datamodule as jax_datamodule
from vision_mtl_tpu.data import loader as jax_loader
from vision_mtl_tpu.data import native as jax_native
from vision_mtl_tpu.data import synthetic as jax_synthetic
from vision_mtl_tpu.data import transforms as jax_transforms
from vision_mtl_tpu_torch.cfg import ResizeSpec, cityscapes_data_cfg
from vision_mtl_tpu_torch.data import cityscapes, datamodule, loader, synthetic, transforms

SYN = dict(height=12, width=20, num_classes=5, num_train=11, num_val=6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def syn_cfgs(monkeypatch):
    """Both packages' synthetic config singletons at a tiny size."""
    for mod in (jax_synthetic, synthetic):
        for k, v in SYN.items():
            monkeypatch.setattr(mod.synthetic_data_cfg, k, v)


@pytest.fixture(scope="module")
def cs_tree(tmp_path_factory):
    """6 train and 4 val triples at 16x32: f32 images in [0, 1], int64
    labels with -1, f32 inverse depth."""
    root = tmp_path_factory.mktemp("cityscapes")
    rng = np.random.default_rng(3)
    for stage, n in (("train", 6), ("val", 4)):
        for sub in ("image", "label", "depth"):
            (root / stage / sub).mkdir(parents=True)
        for i in range(n):
            np.save(root / stage / "image" / f"{i:04d}.npy",
                    rng.uniform(0, 1, (16, 32, 3)).astype(np.float32))
            np.save(root / stage / "label" / f"{i:04d}.npy",
                    rng.integers(-1, 19, (16, 32)).astype(np.int64))
            np.save(root / stage / "depth" / f"{i:04d}.npy",
                    rng.uniform(0, 1, (16, 32)).astype(np.float32))
    return str(root)


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("stage", ["train", "val"])
def test_synthetic_samples_match_jax(syn_cfgs, stage):
    want = jax_synthetic.SyntheticMTLDataset(stage=stage)
    got = synthetic.SyntheticMTLDataset(stage=stage)
    assert len(got) == len(want) == (11 if stage == "train" else 6)
    for i in range(len(want)):
        _assert_batches_equal(got[i], want[i])
    _assert_batches_equal(got.load_benchmark_batch(), want.load_benchmark_batch())


@pytest.mark.parametrize("stage", ["train", "val"])
def test_cityscapes_samples_match_jax(cs_tree, stage):
    """Sample by sample, without a transform (bit for bit) and with the
    default 128x256 one (nearest ids and depth bit for bit, bilinear images
    within 1e-5)."""
    for transforms in (None, jax_cityscapes.UNSET):
        kw = {} if transforms is jax_cityscapes.UNSET else {"transforms": None}
        want = jax_cityscapes.CityscapesDataset(stage=stage, data_base_dir=cs_tree, **kw)
        got = cityscapes.CityscapesDataset(stage=stage, data_base_dir=cs_tree, **kw)
        assert len(got) == len(want) == (6 if stage == "train" else 4)
        for i in range(len(want)):
            g, w = got[i], want[i]
            assert g["mask"].min() >= 0 and g["mask"].max() == 18  # -1 folded into 18
            if transforms is None:
                _assert_batches_equal(g, w)
                continue
            assert g["img"].shape == (128, 256, 3) and g["img"].dtype == np.float32
            np.testing.assert_allclose(g["img"], w["img"], rtol=0, atol=1e-5)
            for k in ("mask", "depth"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_cityscapes_missing_tree(tmp_path):
    with pytest.raises(FileNotFoundError) as want:
        jax_cityscapes.CityscapesDataset(stage="train", data_base_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        cityscapes.CityscapesDataset(stage="train", data_base_dir=str(tmp_path))
    assert str(got.value) == str(want.value)


# (loader kwargs, skip_batches of the second epoch)
LOADER_CASES = [
    (dict(batch_size=4, shuffle=True, seed=5, drop_last=True, num_workers=2), 0),
    (dict(batch_size=4, shuffle=True, seed=5, drop_last=True), 1),
    (dict(batch_size=4, pad_last=True, num_workers=3), 0),
    (dict(batch_size=3, shuffle=True, seed=2, with_valid=True), 2),
]


@pytest.mark.parametrize("wire", ["f32", "compact"])
@pytest.mark.parametrize("case", range(len(LOADER_CASES)))
def test_loader_matches_jax_over_epochs(syn_cfgs, case, wire):
    """Three epochs of batches, every array equal: the seeded shuffle per
    epoch, drop_last, pad_last with valid, the one-shot skip_batches, and
    both wire formats."""
    kwargs, skip = LOADER_CASES[case]
    want_loader = jax_loader.DataLoader(
        jax_synthetic.SyntheticMTLDataset(stage="train"), wire_format=wire, **kwargs
    )
    got_loader = loader.DataLoader(
        synthetic.SyntheticMTLDataset(stage="train"), wire_format=wire, **kwargs
    )
    assert len(got_loader) == len(want_loader)
    for epoch in range(3):
        if epoch == 1:
            want_loader.skip_batches = got_loader.skip_batches = skip
        want, got = list(want_loader), list(got_loader)
        assert len(got) == len(want) > 0, epoch
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
        assert got_loader.epoch == want_loader.epoch == epoch + 1
        assert got_loader.skip_batches == 0


@pytest.mark.parametrize("do_overfit", [False, True])
def test_datamodule_split_matches_jax(syn_cfgs, do_overfit):
    kw = dict(dataset_name="synthetic", batch_size=4, do_overfit=do_overfit, seed=7)
    want = jax_datamodule.MTLDataModule(**kw)
    got = datamodule.MTLDataModule(**kw)
    want.setup()
    got.setup()
    assert got.wire_format == want.wire_format == "f32"
    assert list(got.data_train.indices) == list(want.data_train.indices)
    assert list(got.data_val.indices) == list(want.data_val.indices)
    assert len(got.data_predict) == len(want.data_predict)
    _assert_batches_equal(got.benchmark_batch, want.benchmark_batch)
    for make in ("train_dataloader", "val_dataloader", "predict_dataloader"):
        for g, w in zip(getattr(got, make)(), getattr(want, make)()):
            _assert_batches_equal(g, w)


def test_datamodule_cityscapes_tree(cs_tree, monkeypatch, capsys):
    """The benchmark ids (955-2325) lie beyond a small tree: both report
    and go on without the batch; val reads the 'val' stage; nyuv2 builds
    its dataset, which finds no tree here. Both decode through their
    native batch path (the same C++), which without a transform resizes to
    the config's 128x256."""
    assert jax_native.available()
    monkeypatch.setattr(jax_cityscapes_cfg, "data_dir", cs_tree)
    monkeypatch.setattr(cityscapes_data_cfg, "data_dir", cs_tree)
    kw = dict(dataset_name="cityscapes", batch_size=2, seed=3,
              train_transform=None, test_transform=None)
    want = jax_datamodule.MTLDataModule(**kw)
    got = datamodule.MTLDataModule(**kw)
    want.setup()
    got.setup()
    out = capsys.readouterr().out
    assert out.count("Failed to load benchmark batch") == 2
    assert got.benchmark_batch is None and want.benchmark_batch is None
    assert got.wire_format == "compact"
    assert list(got.data_train.indices) == list(want.data_train.indices)
    assert list(got.data_val.indices) == list(want.data_val.indices)
    assert len(got.data_predict) == 4 and got.data_predict.stage == "val"
    for make in ("train_dataloader", "val_dataloader", "predict_dataloader"):
        g_all, w_all = list(getattr(got, make)()), list(getattr(want, make)())
        assert len(g_all) == len(w_all)
        for g, w in zip(g_all, w_all):
            _assert_batches_equal(g, w)
            assert g["img"].shape[1:] == (128, 256, 3)
    with pytest.raises(RuntimeError, match="Dataset not complete"):
        datamodule._make_dataset("nyuv2", "train", None)


def _pil(arr, h, w, resample):
    return np.asarray(Image.fromarray(arr).resize((w, h), resample=resample))


@pytest.mark.parametrize(
    "src,dst", [((16, 32), (128, 256)), ((48, 64), (25, 25)), ((37, 53), (19, 71)), ((5, 9), (23, 31))]
)
def test_resize_matches_pil(src, dst):
    """Bilinear up and down within 1e-5 of the input's largest magnitude
    of PIL's (f32 sums in another order; in 400 random shapes of 1-119
    pixels a side only an output one pixel wide missed it), nearest bit
    for bit; the JAX package's transforms give PIL's."""
    rng = np.random.default_rng(sum(src + dst))
    spec_j = JaxResizeSpec(*dst)
    spec = ResizeSpec(*dst)
    img = rng.uniform(0, 1, src + (3,)).astype(np.float32)
    got, want = transforms.resize_image(img, spec), jax_transforms.resize_image(img, spec_j)
    assert got.shape == want.shape == dst + (3,) and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[..., 0], _pil(img[..., 0], *dst, Image.BILINEAR), atol=1e-5)
    for dtype in (np.int64, np.int32, np.uint8):
        mask = rng.integers(0, 19, src).astype(dtype)
        got, want = transforms.resize_mask(mask, spec), jax_transforms.resize_mask(mask, spec_j)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got = transforms.resize_mask(mask, spec, bilinear=True)
    np.testing.assert_allclose(got, jax_transforms.resize_mask(mask, spec_j, bilinear=True),
                               rtol=0, atol=1e-5 * 18)
    depth = rng.uniform(0, 10, src + (1,)).astype(np.float32)
    for bilinear in (False, True):
        got = transforms.resize_depth(depth, spec, bilinear=bilinear)
        want = jax_transforms.resize_depth(depth, spec_j, bilinear=bilinear)
        assert got.shape == want.shape == dst + (1,)
        if bilinear:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 10)
        else:
            np.testing.assert_array_equal(got, want)
    # an array at the target size comes back as it is
    assert transforms.resize_image(img, ResizeSpec(*src)) is img


def test_prefetch_to_device_cpu_yields_the_loader_batches(syn_cfgs):
    dl = loader.DataLoader(synthetic.SyntheticMTLDataset(stage="val"), batch_size=4,
                           pad_last=True, wire_format="compact")
    want = list(dl)
    got = list(loader.prefetch_to_device(dl, "cpu", size=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in g.values())
        _assert_batches_equal({k: v.numpy() for k, v in g.items()}, w)
    with pytest.raises(ValueError, match="unsupported device"):
        next(loader.prefetch_to_device(dl, "meta"))
