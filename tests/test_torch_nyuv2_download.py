"""NYUv2's archives extracted offline: the port's ``NYUv2.download`` against
the JAX package's on tiny archives the test writes itself (RGB and
13-class label ``.tgz`` files, the surface-normal ``.zip``, an h5py
``.mat`` of depth maps), each package on its own copy. The same file
names come out; the port's 16-bit depth PNGs (written with zlib) decode,
through the port's reader, to PIL's decode of JAX's (written by PIL); the
two datasets read the same samples; a missing archive raises JAX's
message. No test touches the network: ``urlretrieve`` is replaced."""

import io
import os
import shutil
import tarfile
import urllib.request
import zipfile

import numpy as np
import pytest
from PIL import Image

from vision_mtl_tpu.data import nyuv2 as jax_nyuv2
from vision_mtl_tpu_torch.data import native
from vision_mtl_tpu_torch.data import nyuv2

IDS = {"train": ["0001", "0003"], "test": ["0002"]}
H, W = 6, 5


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _add(tar, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def _write_archives(root, rng):
    """The four archives under their published names, in ``root``; the
    depth maps in metres, stored transposed as the official ``.mat`` does."""
    import h5py

    os.makedirs(root)
    for split, ids in IDS.items():
        with tarfile.open(os.path.join(root, f"nyu_{split}_rgb.tgz"), "w:gz") as tar:
            for i in ids:
                rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
                _add(tar, f"nyu_rgb_{i}.png", _png_bytes(rgb))
        with tarfile.open(os.path.join(root, f"nyuv2_{split}_class13.tgz"), "w:gz") as tar:
            for i in ids:
                seg = rng.integers(0, 14, (H, W), dtype=np.uint8)
                _add(tar, f"new_nyu_class13_{i}.png", _png_bytes(seg))
    with zipfile.ZipFile(os.path.join(root, "nyu_normals_gt.zip"), "w") as zf:
        for split, ids in IDS.items():
            for i in ids:
                zf.writestr(f"{split}/x{i}.png",
                            _png_bytes(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)))
    depths = rng.uniform(0.5, 6.5535, (3, W, H)).astype(np.float32)
    with h5py.File(os.path.join(root, "nyu_depth_v2_labeled.mat"), "w") as f:
        f.create_dataset("depths", data=depths)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The archives, then ``download()`` of each package on its own copy."""
    base = tmp_path_factory.mktemp("nyu")
    _write_archives(str(base / "archives"), np.random.default_rng(4))
    roots = {}
    for name, pkg in (("port", nyuv2), ("jax", jax_nyuv2)):
        root = str(base / name)
        shutil.copytree(str(base / "archives"), root)
        ds = pkg.NYUv2(stage="train", data_base_dir=root, download=True, use_sn=True,
                       transforms=None)
        roots[name] = (root, ds)
    return roots


def _listing(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root) for f in files
    )


def test_download_builds_jax_tree(trees):
    """The same files under the same names: the renamed RGB and label
    images, the normals without their first letter, the depth PNGs split
    by the train ids, the archives left in place."""
    port, jax = (_listing(trees[k][0]) for k in ("port", "jax"))
    assert port == jax
    for split, ids in IDS.items():
        for part in ("rgb", "seg13", "depth", "sn"):
            assert {f for f in port if f.startswith(f"{split}_{part}/")} == \
                {f"{split}_{part}/{i}.png" for i in ids}


def test_depth_pngs_decode_as_pils(trees):
    """The port's zlib-written 16-bit depth PNG, through the port's reader,
    is PIL's decode of JAX's PIL-written one, value for value: metres x 1e4
    truncated to uint16, the ``.mat``'s map transposed."""
    for split, ids in IDS.items():
        for i in ids:
            rel = os.path.join(f"{split}_depth", f"{i}.png")
            want = np.asarray(Image.open(os.path.join(trees["jax"][0], rel)))
            assert want.dtype == np.uint16 and want.shape == (H, W)
            got = native.read_png(os.path.join(trees["port"][0], rel))
            np.testing.assert_array_equal(got, want.astype(np.float32))
            np.testing.assert_array_equal(
                np.asarray(Image.open(os.path.join(trees["port"][0], rel))), want)


def test_datasets_read_the_same_samples(trees):
    """The port's dataset over the port's tree reads what JAX's reads over
    JAX's (no resize): images, ids, depths and normals."""
    port_ds, jax_ds = trees["port"][1], trees["jax"][1]
    assert len(port_ds) == len(jax_ds) == len(IDS["train"])
    for i in range(len(jax_ds)):
        got, want = port_ds[i], jax_ds[i]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_missing_archive_raises_jaxs_message(tmp_path, monkeypatch):
    """No archive and no network: the port's message is JAX's, word for
    word, and the dataset raises it from ``download=True``."""

    def offline(url, dst):
        raise OSError("network is unreachable")

    monkeypatch.setattr(urllib.request, "urlretrieve", offline)
    url = "http://www.doc.ic.ac.uk/~ahanda/nyu_train_rgb.tgz"
    with pytest.raises(RuntimeError) as want:
        jax_nyuv2._fetch(url, str(tmp_path))
    with pytest.raises(RuntimeError) as got:
        nyuv2._fetch(url, str(tmp_path))
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="Place the archive at"):
        nyuv2.NYUv2(stage="train", data_base_dir=str(tmp_path / "empty"), download=True)


def test_write_png16_refuses_other_arrays(tmp_path):
    with pytest.raises(ValueError, match="uint16"):
        nyuv2.write_png16(str(tmp_path / "a.png"), np.zeros((2, 2), np.uint8))
