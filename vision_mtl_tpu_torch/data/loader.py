"""Host-side batch loader with threaded sample decode, and the copy to the
card through pinned memory (counterpart of ``vision_mtl_tpu/data/loader.py``).

  * static batch shapes: train drops the ragged last batch; eval pads it by
    repeating the last sample and adds a per-sample ``valid`` weight;
  * a dataset's ``load_batch(idxs)`` decodes a whole batch (the native
    Cityscapes path, the NYUv2 cache); where it returns None, or raises
    ``native.DecodeError`` on a file, the samples are decoded one by one;
  * ``num_workers`` is a thread pool (numpy decode releases the GIL);
  * the batch order is the JAX loader's: a numpy ``default_rng(seed +
    epoch)`` permutation, the epoch counted by ``__iter__``;
  * ``prefetch_to_device`` keeps ``size`` batches in flight on a side
    stream while the current one is consumed;
  * under several ranks (``parallel/multihost.py``) every rank computes the
    same seeded global order and decodes only its contiguous
    ``batch_size / world`` rows of each global batch: train batches drop
    the ragged last batch, eval batches pad the global batch and ``valid``
    marks the rank's padded rows. ``shard_rows=False`` (the mesh's
    ``spatial`` axis) decodes the whole global batch on every rank, as the
    JAX loader's full-batch mode does.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import typing as t

import numpy as np
import torch

from vision_mtl_tpu_torch.data.native import DecodeError
from vision_mtl_tpu_torch.parallel.multihost import process_info

Batch = t.Dict[str, np.ndarray]


def _collate(samples: t.Sequence[t.Dict[str, np.ndarray]]) -> Batch:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


def compress_batch(batch: Batch) -> Batch:
    """The compact wire: img uint8 (x255), depth uint16 (x65535; values are
    normalised to [0, 1]), mask uint8 when its ids fit. The steps decode it
    on the device (``train/step.decode_batch``): 4x fewer bytes to copy.
    Exact for masks and uint8-sourced images; depth within 1.6e-5."""
    out: Batch = {}
    for k, v in batch.items():
        if k == "img" and v.dtype == np.float32:
            out[k] = np.clip(np.rint(v * 255.0), 0, 255).astype(np.uint8)
        elif k == "depth" and v.dtype == np.float32:
            out[k] = np.clip(np.rint(v * 65535.0), 0, 65535).astype(np.uint16)
        elif k == "mask" and v.max() < 256 and v.min() >= 0:
            out[k] = v.astype(np.uint8)
        else:
            out[k] = v
    return out


def _pad_batch(batch: Batch, target_bs: int) -> Batch:
    """Pad to ``target_bs`` by repeating the last sample; adds 'valid'."""
    bs = next(iter(batch.values())).shape[0]
    out: Batch = {}
    for k, v in batch.items():
        if bs < target_bs:
            pad = np.repeat(v[-1:], target_bs - bs, axis=0)
            out[k] = np.concatenate([v, pad], axis=0)
        else:
            out[k] = v
    valid = np.zeros((target_bs,), np.float32)
    valid[:bs] = 1.0
    out["valid"] = valid
    return out


class DataLoader:
    """Iterable over collated numpy batches."""

    def __init__(
        self,
        dataset: t.Any,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        pad_last: bool = False,
        num_workers: int = 0,
        with_valid: bool = False,
        wire_format: str = "f32",
        shard_rows: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_workers = num_workers
        self.with_valid = with_valid
        self.wire_format = wire_format
        self.shard_rows = shard_rows
        self.epoch = 0
        # one-shot: the next iteration skips this many leading batches
        # without decoding them, then resets it to 0
        self.skip_batches = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> t.List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        batches = [order[i : i + self.batch_size] for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    @staticmethod
    def _process_shard() -> t.Tuple[int, int]:
        """(rank, world size); (0, 1) in one process."""
        return process_info()

    def __iter__(self) -> t.Iterator[Batch]:
        batches = self._index_batches()
        if self.skip_batches:
            batches = batches[self.skip_batches :]
            self.skip_batches = 0
        self.epoch += 1

        rank, world = self._process_shard() if self.shard_rows else (0, 1)
        if world > 1:
            if self.batch_size % world:
                raise ValueError(
                    f"global batch_size {self.batch_size} must divide by the {world} ranks "
                    "for row-sharded loading"
                )
            if not (self.drop_last or self.pad_last):
                raise ValueError(
                    "row-sharded loading needs static global batches: construct the "
                    "DataLoader with drop_last or pad_last"
                )
        per = self.batch_size // world

        pool = cf.ThreadPoolExecutor(self.num_workers) if self.num_workers > 0 else None
        load_batch = getattr(self.dataset, "load_batch", None)
        try:
            for idxs in batches:
                valid_local: t.Optional[np.ndarray] = None
                if world > 1:
                    lo, hi = rank * per, (rank + 1) * per
                    n_real = len(idxs)
                    if self.pad_last:
                        # pad the global batch with its last sample, then
                        # take this rank's rows; valid marks the padding
                        idxs = np.asarray([idxs[min(r, n_real - 1)] for r in range(lo, hi)])
                        valid_local = (np.arange(lo, hi) < n_real).astype(np.float32)
                    else:
                        idxs = idxs[lo:hi]
                batch = None
                if load_batch is not None:
                    try:
                        batch = load_batch([int(i) for i in idxs])
                    except DecodeError:
                        # a file the native parser cannot read: the
                        # per-sample path reads it or names it
                        batch = None
                if batch is None:
                    if pool is not None:
                        futures = [pool.submit(self.dataset.__getitem__, int(i)) for i in idxs]
                        samples = [f.result() for f in futures]
                    else:
                        samples = [self.dataset[int(i)] for i in idxs]
                    batch = _collate(samples)
                if world > 1:
                    if valid_local is not None:
                        batch["valid"] = valid_local
                    elif self.with_valid:
                        batch["valid"] = np.ones((per,), np.float32)
                elif self.pad_last:
                    batch = _pad_batch(batch, self.batch_size)
                elif self.with_valid:
                    batch["valid"] = np.ones((len(idxs),), np.float32)
                if self.wire_format == "compact":
                    batch = compress_batch(batch)
                yield batch
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)


def prefetch_to_device(
    iterator: t.Iterable[t.Mapping[str, np.ndarray]],
    device: t.Union[str, torch.device],
    size: int = 2,
) -> t.Iterator[t.Dict[str, torch.Tensor]]:
    """Yield each numpy batch as tensors on ``device``, with ``size`` batches
    in flight.

    On the CPU the tensors share the numpy arrays' memory. On a card each
    batch is pinned and copied with ``non_blocking`` on a side stream; the
    consumer's stream waits on an event recorded after the copy before it
    reads the batch, and the batch's tensors are recorded on that stream, so
    the caching allocator does not hand their memory to a later copy while
    work queued on it still reads them. Each pinned source is held until
    its copy's event has completed. A failed pin or copy raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        for batch in iterator:
            yield {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        return
    if dev.type != "cuda":
        raise ValueError(f"prefetch_to_device: unsupported device {dev}")

    copy_stream = torch.cuda.Stream(dev)
    in_flight: collections.deque = collections.deque()
    sources: collections.deque = collections.deque()  # (event, pinned batch)

    def put(batch: t.Mapping[str, np.ndarray]) -> None:
        pinned = {
            k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for k, v in batch.items()
        }
        done = torch.cuda.Event()
        with torch.cuda.stream(copy_stream):
            out = {k: v.to(dev, non_blocking=True) for k, v in pinned.items()}
            done.record(copy_stream)
        in_flight.append((out, done))
        sources.append((done, pinned))

    it = iter(iterator)
    for batch in it:
        put(batch)
        if len(in_flight) == size:
            break
    while in_flight:
        out, done = in_flight.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for v in out.values():
            v.record_stream(consumer)
        nxt = next(it, None)
        if nxt is not None:
            put(nxt)
        while sources and sources[0][0].query():
            sources.popleft()
        yield out
