"""Build, load and count the hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface; sources may
share ``csrc/*.cuh`` headers. At first use it is compiled by ``nvcc`` for
``sm_90a`` into a shared library under the checkout's ``build/kernels/``
(named after a hash of its source, the headers and the flags, so an edited
source or header never loads a stale build) and loaded with ``ctypes``.
Nothing here runs when a module is imported: the CPU tests import every
module, and a machine without a card may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import typing as t
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_fns: t.Dict[str, t.Callable[..., int]] = {}
_lock = threading.Lock()


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one where it launches."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


class EntryPoint:
    """A further kernel of a source that has one already (the task-axis
    gates): the ``SOURCE`` it builds from and its own launch count, as a
    kernel's module has them."""

    def __init__(self, source: str) -> None:
        self.SOURCE = source
        self.launches = LaunchCounter()


def nvcc_path() -> str:
    cuda_home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    if (cuda_home / "bin" / "nvcc").exists():
        return str(cuda_home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes: named after a hash of the
    source, every header of ``csrc/`` (a source may include any) and the
    flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: t.Iterable[str]) -> t.List[Path]:
    """Compile every named kernel that has no current build, one ``nvcc``
    per source, all started together; raises with the compiler's output if
    any build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, lib, tmp, proc))
    failures = []
    for name, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return [library_path(name) for name in names]


def load(
    name: str, symbol: str, signature: t.Sequence[t.Any], restype: t.Any = ctypes.c_int
) -> t.Callable[..., int]:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, built on first
    use; ``signature`` gives its ctypes argument types, ``restype`` its
    result type."""
    with _lock:
        fn = _fns.get(symbol)
        if fn is None:
            (path,) = build([name])
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = list(signature)
            fn.restype = restype
            _fns[symbol] = fn
    return fn
