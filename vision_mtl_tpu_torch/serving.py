"""Serving (counterpart of ``vision_mtl_tpu/serving.py``):

  * ``Predictor`` — a fixed-batch-size inference callable with automatic
    padding of ragged final batches;
  * ``BatchingServer`` — dynamic micro-batching: concurrent single-image
    requests are coalesced into fixed-size bucket batches and demultiplexed
    back to per-request futures;
  * ``latency_bench`` — p50/p95/p99 request latency, synchronised by the
    output fetch;
  * ``export_model`` / ``load_exported`` — the eval-mode predict function
    with its weights as a ``torch.export`` program in one file, and the
    callable that runs it.

PyTorch runs eagerly, so there is no ahead-of-time compile: a ``Predictor``
is ready at construction and ``warmup`` pays the first launches (and the
CUDA kernels' first-use build). A ``Predictor`` serves a snapshot of the
model taken at construction, as the JAX one serves the weights it was
given: later training of the caller's module changes neither its answers
nor is it touched by them. An exported program reaches kernels B1 and
B3 through their operators (``torch.ops.vmtl.*``), which the kernels
package registers when it is imported.

With a ``mesh`` of several ranks (``parallel/mesh.py``), a ``Predictor``
splits the request batch over the ranks, by data index along the batch and
by spatial index along the image rows: every rank is called with the same
images, runs its block on its own snapshot, and the blocks of the answer
are gathered exactly (``Mesh.gather``), so every rank returns the whole
answer. A ``BatchingServer``
takes requests on rank 0, which broadcasts each coalesced batch; the other
ranks serve them through :meth:`BatchingServer.follow` until rank 0 closes.
"""

from __future__ import annotations

import concurrent.futures
import copy
import queue
import threading
import time
import typing as t

import numpy as np
import torch
from torch import nn

from vision_mtl_tpu_torch.device import resolve_device
from vision_mtl_tpu_torch.train.step import make_predict_step, predict_outputs


class Predictor:
    """Fixed-shape predictor on one device.

    It serves a private eval-mode copy of ``model`` taken at construction
    (one model's parameters and buffers of device memory): the caller's
    module, its weights and its mode are never touched, and training it
    later does not change the answers.

    ``dtype`` is the wire type of the images: float32 (normalised) or uint8
    (raw; normalised on the device, /255 in f32). ``compact_out`` returns
    segm as uint8 (lossless: every head has <= 255 classes) and depth as
    float16, cutting the device-to-host payload.

    ``mesh``: the ranks split each batch, its rows over the ``data`` axis
    (``batch_size`` must divide by its size) and its image rows over
    ``spatial``, and every rank returns the whole answer; the model is this
    rank's copy, on ``mesh.device``. Collective: every rank makes the same
    calls with the same images.
    """

    def __init__(
        self,
        model: nn.Module,
        batch_size: int,
        height: int,
        width: int,
        channels: int = 3,
        dtype: t.Any = np.float32,
        compact_out: bool = False,
        device: t.Union[str, torch.device] = "cuda",
        mesh: t.Any = None,
    ):
        self._mesh = mesh if mesh is not None and mesh.world > 1 else None
        self._comm = self._mesh.comm if self._mesh is not None else None
        self.device = resolve_device(mesh.device if mesh is not None else device)
        p = next(model.parameters())
        if p.device != self.device:
            raise ValueError(
                f"model parameters are on {p.device}, predictor device is "
                f"{self.device}: move the model first"
            )
        if model.training:
            raise ValueError("Predictor needs a model in eval mode (model.eval())")
        self.model = copy.deepcopy(model).requires_grad_(False)
        self._step = make_predict_step(self.model, self._mesh)
        self.batch_size = batch_size
        self.shape = (batch_size, height, width, channels)
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.float32, np.uint8):
            raise ValueError(f"wire dtype must be float32 or uint8, got {self.dtype}")
        self.compact_out = compact_out
        self._check_batch_size(batch_size)

    def _check_batch_size(self, batch_size: int) -> None:
        if self._mesh is not None and batch_size % self._mesh.size("data"):
            raise ValueError(
                f"batch size {batch_size} does not divide over the mesh's "
                f"{self._mesh.size('data')} ranks of its data axis"
            )

    def _with_batch_size(self, batch_size: int) -> "Predictor":
        """This predictor, serving the same snapshot, at another batch
        size."""
        self._check_batch_size(batch_size)
        other = copy.copy(self)
        other.batch_size = batch_size
        other.shape = (batch_size,) + self.shape[1:]
        return other

    def _run(self, img: torch.Tensor) -> t.Dict[str, torch.Tensor]:
        out = self._step(img)
        if self._mesh is not None:
            out = {k: self._mesh.gather(v) for k, v in out.items()}
        if self.compact_out:
            out = {"segm": out["segm"].to(torch.uint8), "depth": out["depth"].to(torch.float16)}
        return out

    def dispatch(self, imgs: np.ndarray) -> t.Tuple[t.Dict[str, torch.Tensor], int]:
        """Queue the forward on the device and return ``(device_out, n)``
        WITHOUT waiting for completion or fetching outputs — pair with
        :meth:`fetch`, so the device computes one batch while the host
        fetches the previous one."""
        n = imgs.shape[0]
        if n > self.batch_size:
            raise ValueError(f"batch {n} exceeds the batch size {self.batch_size}")
        if n == 0:
            raise ValueError("empty request: need at least one image to pad from")
        if imgs.shape[1:] != self.shape[1:] or imgs.dtype != self.dtype:
            raise ValueError(
                f"expected images of shape (N,)+{self.shape[1:]} and dtype "
                f"{self.dtype}, got {imgs.shape} {imgs.dtype}"
            )
        if n < self.batch_size:
            pad = np.repeat(imgs[-1:], self.batch_size - n, axis=0)
            imgs = np.concatenate([imgs, pad], axis=0)
        if self._mesh is not None:  # this rank's block
            imgs = self._mesh.block({"img": imgs})["img"]
        img = torch.from_numpy(np.ascontiguousarray(imgs))
        if self.device.type == "cuda":
            # from pinned memory the copy is queued, not waited for
            img = img.pin_memory().to(self.device, non_blocking=True)
        return self._run(img), n

    def fetch(self, out: t.Dict[str, torch.Tensor], n: int) -> t.Dict[str, np.ndarray]:
        """Complete a :meth:`dispatch`: copy outputs to the host (the sync
        point) and strip padding rows."""
        return {k: v[:n].cpu().numpy() for k, v in out.items()}

    def __call__(self, imgs: np.ndarray) -> t.Dict[str, np.ndarray]:
        return self.fetch(*self.dispatch(imgs))


class BatchingServer:
    """Dynamic micro-batching over fixed-size bucket predictors.

    A background worker drains a request queue, coalesces up to
    ``max(buckets)`` images (waiting at most ``max_wait_ms`` after the first
    request of a batch), runs the smallest bucket that fits, and resolves
    each request's future with its own slice of the output. A ragged tail
    pads only up to the next bucket.

    Execution is two-stage pipelined: the batching worker only *dispatches*
    a batch (asynchronous on the card) and hands the in-flight outputs to a
    fetch thread that copies them to the host and resolves the futures.
    ``max_in_flight`` bounds the dispatch-ahead depth so a slow fetch
    backpressures the queue instead of piling device work.

    Thread-safe; use as a context manager or call :meth:`close`.

    ``mesh`` (several ranks): every bucket is a :class:`Predictor` over the
    ranks. Rank 0 takes the requests and broadcasts each batch it
    dispatches; every other rank calls :meth:`follow`, which runs those
    batches until rank 0's server closes. Each rank makes its collective
    calls from one thread at a time: rank 0's worker, a follower's caller.
    """

    def __init__(
        self,
        model: nn.Module,
        height: int,
        width: int,
        buckets: t.Sequence[int] = (1, 4, 8),
        max_wait_ms: float = 2.0,
        channels: int = 3,
        dtype: t.Any = np.float32,
        max_in_flight: int = 2,
        compact_out: bool = False,
        device: t.Union[str, torch.device] = "cuda",
        mesh: t.Any = None,
    ):
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        self._buckets = sorted(set(int(b) for b in buckets))
        # one snapshot of the model serves every bucket
        first = Predictor(model, self._buckets[0], height, width, channels=channels,
                          dtype=dtype, compact_out=compact_out, device=device, mesh=mesh)
        self._comm = first._comm
        self._predictors = {b: first._with_batch_size(b) for b in self._buckets}
        self._sample_shape = (height, width, channels)
        self._wire_dtype = np.dtype(dtype)
        self._max_wait_s = max_wait_ms / 1000.0
        self._queue: "queue.Queue[t.Optional[tuple]]" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "batches": 0,
            "batched_images": 0,
            "padded_slots": 0,
        }
        # dispatched-but-unfetched batches; bounded so dispatch backpressures
        self._inflight: "queue.Queue[t.Optional[tuple]]" = queue.Queue(maxsize=max_in_flight)
        if self._comm is not None and self._comm.rank != 0:
            return  # a follower: no request queue of its own (follow)
        self._fetcher = threading.Thread(
            target=self._run_fetch, name="vmtl-batching-fetch", daemon=True
        )
        self._fetcher.start()
        self._worker = threading.Thread(
            target=self._run, name="vmtl-batching-server", daemon=True
        )
        self._worker.start()

    # -- client side ------------------------------------------------------

    def submit(self, img: np.ndarray) -> "concurrent.futures.Future":
        """Enqueue one HWC image; the future resolves to ``{"segm","depth"}``
        for that image alone."""
        img = np.asarray(img)
        if img.shape != self._sample_shape:
            raise ValueError(
                f"expected one image of shape {self._sample_shape}, got {img.shape}"
            )
        if img.dtype != self._wire_dtype:
            raise ValueError(f"server takes {self._wire_dtype} images, got {img.dtype}")
        if self._comm is not None and self._comm.rank != 0:
            raise RuntimeError(
                f"rank {self._comm.rank} follows rank 0's batches: submit requests on rank 0"
            )
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("BatchingServer is closed")
            self._stats["requests"] += 1
            self._queue.put((img, fut))
        return fut

    def predict(self, img: np.ndarray) -> t.Dict[str, np.ndarray]:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(img).result()

    def warmup(self) -> None:
        """Run every bucket once on a dummy image, so that no first launch
        (nor the kernels' first-use build) lands inside a measured window;
        pair with :meth:`reset_stats`."""
        dummy = np.zeros(self._sample_shape, dtype=self._wire_dtype)[None]
        for pred in self._predictors.values():
            pred.fetch(*pred.dispatch(dummy))

    def reset_stats(self) -> None:
        """Zero the request/batch/occupancy counters (e.g. after warm-up)."""
        with self._lock:
            for k in self._stats:
                self._stats[k] = 0

    def stats(self) -> t.Dict[str, float]:
        with self._lock:
            s = dict(self._stats)
        s["mean_batch_occupancy"] = s["batched_images"] / max(
            1, s["batched_images"] + s["padded_slots"]
        )
        return s

    def follow(self) -> None:
        """A follower rank's serving loop: run each batch rank 0 broadcasts,
        until rank 0's server closes."""
        if self._comm is None or self._comm.rank == 0:
            raise RuntimeError("follow() is for the ranks other than 0 of a mesh")
        while True:
            item = self._comm.broadcast_object(None)
            if item is None:
                return
            bucket, imgs = item
            pred = self._predictors[bucket]
            pred.fetch(*pred.dispatch(imgs))

    def close(self) -> None:
        """Stop the workers after draining already-submitted requests."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._comm is not None and self._comm.rank != 0:
            return
        self._queue.put(None)
        self._worker.join()
        self._fetcher.join()

    def __enter__(self) -> "BatchingServer":
        return self

    def __exit__(self, *exc: t.Any) -> None:
        self.close()

    # -- worker side ------------------------------------------------------

    @staticmethod
    def _resolve(
        fut: "concurrent.futures.Future",
        result: t.Any = None,
        exc: t.Optional[BaseException] = None,
    ) -> None:
        """Resolve a request future, tolerating a client-side ``cancel()``
        (``set_result`` on a cancelled future would kill the fetch thread)."""
        if not fut.set_running_or_notify_cancel():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)

    def _run(self) -> None:
        max_bucket = self._buckets[-1]
        try:
            while True:
                first = self._queue.get()
                if first is None:
                    return
                pending = [first]
                deadline = time.monotonic() + self._max_wait_s
                while len(pending) < max_bucket:
                    remain = deadline - time.monotonic()
                    try:
                        item = (
                            self._queue.get_nowait()
                            if remain <= 0
                            else self._queue.get(timeout=remain)
                        )
                    except queue.Empty:
                        break
                    if item is None:
                        self._flush(pending)
                        return
                    pending.append(item)
                self._flush(pending)
        finally:
            if self._comm is not None:
                self._comm.broadcast_object(None)  # the followers return
            self._inflight.put(None)  # fetch thread drains, then exits

    def _flush(self, pending: t.List[tuple]) -> None:
        """Dispatch one coalesced batch; futures resolve on the fetch
        thread. Blocks only when ``max_in_flight`` batches are unfetched."""
        n = len(pending)
        bucket = next(b for b in self._buckets if b >= n)
        imgs = np.stack([img for img, _ in pending], axis=0)
        try:
            if self._comm is not None:
                self._comm.broadcast_object((bucket, imgs))
            out, _ = self._predictors[bucket].dispatch(imgs)
        except Exception as e:  # resolve, don't kill the worker
            for _, fut in pending:
                self._resolve(fut, exc=e)
            return
        with self._lock:
            self._stats["batches"] += 1
            self._stats["batched_images"] += n
            self._stats["padded_slots"] += bucket - n
        self._inflight.put((bucket, out, pending))

    def _run_fetch(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            bucket, out, pending = item
            try:
                host = self._predictors[bucket].fetch(out, len(pending))
            except Exception as e:
                for _, fut in pending:
                    self._resolve(fut, exc=e)
                continue
            for i, (_, fut) in enumerate(pending):
                self._resolve(fut, {k: v[i] for k, v in host.items()})


class _PredictFunction(nn.Module):
    """``make_predict_step``'s function (:func:`predict_outputs`) as a
    module for ``torch.export``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, img: torch.Tensor) -> t.Dict[str, torch.Tensor]:
        return predict_outputs(self.model, img)


def export_model(
    model: nn.Module,
    batch_size: int,
    height: int,
    width: int,
    path: str,
    dtype: t.Any = np.float32,
    device: t.Union[str, torch.device] = "cuda",
) -> torch.export.ExportedProgram:
    """Write the inference function of ``model`` (eval mode, on ``device``,
    as ``Predictor`` takes it), its weights included, as a
    ``torch.export`` program at a fixed ``(batch_size, height, width, 3)``
    input of ``dtype`` (float32 or uint8, the wire types), with
    ``torch.export.save``; returns the program."""
    dev = resolve_device(device)
    p = next(model.parameters())
    if p.device != dev:
        raise ValueError(
            f"model parameters are on {p.device}, export device is {dev}: move the model first"
        )
    if model.training:
        raise ValueError("export_model needs a model in eval mode (model.eval())")
    img = torch.from_numpy(np.zeros((batch_size, height, width, 3), np.dtype(dtype))).to(dev)
    with torch.no_grad():
        program = torch.export.export(_PredictFunction(model), (img,))
    torch.export.save(program, path)
    return program


def load_exported(path: str) -> t.Callable[[np.ndarray], t.Dict[str, np.ndarray]]:
    """The program ``export_model`` wrote, as ``fn(imgs) -> {"segm",
    "depth"}`` on host arrays; it runs on the device it was exported on
    (the CUDA kernels build at their first launch)."""
    import vision_mtl_tpu_torch.kernels  # noqa: F401  (registers the vmtl operators)

    program = torch.export.load(path)
    module = program.module()
    device = next(iter(program.state_dict.values())).device

    def fn(imgs: np.ndarray) -> t.Dict[str, np.ndarray]:
        with torch.inference_mode():
            out = module(torch.from_numpy(np.ascontiguousarray(imgs)).to(device))
        return {k: v.cpu().numpy() for k, v in out.items()}

    return fn


def latency_bench(
    predictor: t.Callable[[np.ndarray], t.Any],
    imgs: np.ndarray,
    n: int = 50,
    warmup: int = 3,
) -> t.Dict[str, float]:
    """Request latency in ms; ``predictor`` must return host arrays (its
    output fetch is the sync that ends each timed request)."""
    for _ in range(warmup):
        predictor(imgs)
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        predictor(imgs)
        lat.append((time.perf_counter() - t0) * 1000.0)
    lat.sort()
    return {
        "p50_ms": lat[len(lat) // 2],
        "p95_ms": lat[int(len(lat) * 0.95)],
        "p99_ms": lat[min(int(len(lat) * 0.99), len(lat) - 1)],
        "mean_ms": sum(lat) / len(lat),
    }
