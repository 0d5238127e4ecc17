"""The port's ctypes binding to the repo's native C++ decoders (counterpart
of ``vision_mtl_tpu/data/native.py``): ``native/fastload.cpp`` (npy parse
and the batched Cityscapes decode, resize and collate on C++ threads) and
``native/png_decode.cpp`` (the zlib PNG decoder NYUv2 reads through: the
port has no PIL path).

At first use both sources are compiled with ``g++`` and the flags of
``native/Makefile`` into one shared library under the checkout's
``build/native/``. Its name hashes the two sources, the flags and the
target that ``-march=native`` resolves to, so an edited source never loads
a stale build and a build for one CPU is not loaded on another. Nothing is
written into ``native/``. A failed build raises with the compiler's
output: NYUv2 has no other decoder here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import typing as t
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("fastload.cpp", "png_decode.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared", "-pthread")

_lib: t.Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
# per-thread decode buffers, reused: a fresh np.empty per call would fault
# in hundreds of MB of pages per image at loader rates
_tls = threading.local()


class DecodeError(RuntimeError):
    """A file the native decoder could not read (the library itself built)."""


def _scratch(max_elems: int) -> np.ndarray:
    buf = getattr(_tls, "buf", None)
    if buf is None or buf.size < max_elems:
        buf = np.empty(max_elems, np.float32)
        _tls.buf = buf
    return buf


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """The build's path: ``build/native/libfastload-<hash>.so``."""
    # a compiler that cannot answer fails in build(), with its output
    target = subprocess.run(
        [_cxx(), "-march=native", "-Q", "--help=target"], capture_output=True, text=True
    ).stdout
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update(name.encode() + (NATIVE_DIR / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode() + target.encode())
    return BUILD_DIR / f"libfastload-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a current build exists; raises
    RuntimeError with the compiler's output if the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, *(str(NATIVE_DIR / s) for s in SOURCES), "-o", str(tmp), "-lz"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native decoder build failed ({' '.join(cmd)} exited {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        f32p, i64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
        for name in ("fastload_read_npy", "fastload_read_png"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, i64p]
        lib.fastload_load_batch.restype = ctypes.c_int
        lib.fastload_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
            f32p,
            ctypes.POINTER(ctypes.c_int32),
            f32p,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def read_npy(path: str, max_elems: int = 64 * 1024 * 1024) -> np.ndarray:
    """Decode an npy file to float32 through the native parser."""
    lib = _load_lib()
    out = _scratch(max_elems)
    shape = np.zeros(8, np.int64)
    ndim = lib.fastload_read_npy(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_elems,
        shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if ndim < 0:
        raise DecodeError(f"native npy decode failed: {path}")
    shp = tuple(int(s) for s in shape[:ndim])
    n = int(np.prod(shp))
    return out[:n].reshape(shp).copy()


def read_png(path: str, max_elems: int = 64 * 1024 * 1024) -> np.ndarray:
    """Decode a PNG (8-bit RGB, RGBA or gray, 16-bit gray; not interlaced)
    to float32 HWC, or HW for one channel. 16-bit values come back in
    0..65535."""
    lib = _load_lib()
    out = _scratch(max_elems)
    shape = np.zeros(4, np.int64)
    ch = lib.fastload_read_png(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_elems,
        shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if ch < 0:
        raise DecodeError(f"native png decode failed: {path}")
    h, w, c, _depth = (int(s) for s in shape)
    arr = out[: h * w * c].reshape(h, w, c).copy()
    return arr[..., 0] if c == 1 else arr


def load_cityscapes_batch(
    img_paths: t.Sequence[str],
    mask_paths: t.Sequence[str],
    depth_paths: t.Sequence[str],
    out_h: int,
    out_w: int,
    ignore_value: int = -1,
    remap_to: int = 18,
    depth_div: float = 1.0,
    num_threads: int = 8,
) -> t.Dict[str, np.ndarray]:
    """Batched decode, resize (bilinear images, nearest masks and depth)
    and collate of npy triples on ``num_threads`` C++ threads; masks'
    ``ignore_value`` becomes ``remap_to``, depth is divided by
    ``depth_div``."""
    lib = _load_lib()
    b = len(img_paths)

    def carr(paths: t.Sequence[str]) -> t.Any:
        arr = (ctypes.c_char_p * b)()
        arr[:] = [p.encode() for p in paths]
        return arr

    imgs = np.empty((b, out_h, out_w, 3), np.float32)
    masks = np.empty((b, out_h, out_w), np.int32)
    depths = np.empty((b, out_h, out_w), np.float32)
    rc = lib.fastload_load_batch(
        carr(img_paths),
        carr(mask_paths),
        carr(depth_paths),
        b,
        out_h,
        out_w,
        ignore_value,
        remap_to,
        ctypes.c_float(depth_div),
        imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        masks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        depths.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads,
    )
    if rc != 0:
        if rc - 1 >= len(img_paths):
            # the batch + 1 sentinel: the worker threads could not be
            # started; no sample is at fault
            raise RuntimeError(
                "native batch load failed: could not spawn worker threads "
                "(memory or thread-limit pressure)"
            )
        raise DecodeError(f"native batch load failed at sample {rc - 1}: {img_paths[rc - 1]}")
    return {"img": imgs, "mask": masks, "depth": depths[..., None]}
