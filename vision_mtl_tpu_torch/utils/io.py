"""Atomic JSON writes and an exclusive file lock (counterpart of
``vision_mtl_tpu/utils/io.py``, the two helpers the port needs)."""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import tempfile
import typing as t


def atomic_write_json(path: str, obj: t.Any, *, fsync: bool = False, **dump_kwargs: t.Any) -> None:
    """Write ``obj`` as JSON to ``path`` through a temporary file in the same
    directory and ``os.replace``. With ``fsync`` the data and the rename
    (through the directory) reach the disk before this returns: for writes
    inside a kill window, such as the preemption sidecar."""
    dirname = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, **dump_kwargs)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            dfd = os.open(dirname, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


@contextlib.contextmanager
def file_lock(path: str) -> t.Iterator[None]:
    """Exclusive ``flock`` on ``path`` (created if absent) for the ``with``
    block; blocks until it is acquired."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
