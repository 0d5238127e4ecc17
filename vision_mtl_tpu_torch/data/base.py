"""Dataset base: host-side decode producing NHWC numpy samples (counterpart
of ``vision_mtl_tpu/data/base.py``).

Sample contract:
  img:   (H, W, 3) float32
  mask:  (H, W)    int32
  depth: (H, W, 1) float32 (the trailing channel is what the SILog loss
         expects)
"""

from __future__ import annotations

import typing as t

import numpy as np

Sample = t.Dict[str, np.ndarray]

# "use the config's value, read at call time": an explicit None means no
# transform, while edits to the config singleton still take effect
UNSET: t.Any = object()


class MTLDataset:
    benchmark_idxs: t.Optional[t.List[int]] = None

    def __init__(
        self,
        stage: str,
        data_base_dir: str,
        max_depth: float,
        train_transform: t.Any = None,
        test_transform: t.Any = None,
    ):
        self.data_base_dir = data_base_dir
        self.train_transform = train_transform
        self.test_transform = test_transform
        self.stage = stage
        self.max_depth = max_depth
        self.transform = train_transform if stage == "train" else test_transform

    def __len__(self) -> int:
        raise NotImplementedError

    def load_raw_sample(self, idx: int) -> Sample:
        raise NotImplementedError

    def prepare_sample(self, raw_sample: Sample, transform: t.Any = None) -> Sample:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Sample:
        return self.prepare_sample(self.load_raw_sample(idx), self.transform)

    def load_benchmark_batch(self) -> t.Optional[Sample]:
        """The fixed benchmark samples, test transform, stacked."""
        if self.benchmark_idxs is None:
            return None
        batch: t.Dict[str, t.List[np.ndarray]] = {"img": [], "mask": [], "depth": []}
        for idx in self.benchmark_idxs:
            sample = self.prepare_sample(self.load_raw_sample(idx), self.test_transform)
            for k in batch:
                batch[k].append(sample[k])
        return {k: np.stack(v, axis=0) for k, v in batch.items()}

    def normalize_depth(self, depth: np.ndarray) -> np.ndarray:
        """Divide by max_depth iff a value exceeds 1."""
        if depth.max() > 1.0:
            depth = depth / self.max_depth
        return depth


class Subset:
    """Index-restricted view of a dataset."""

    def __init__(self, dataset: MTLDataset, indices: t.Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int) -> Sample:
        return self.dataset[self.indices[idx]]

    def load_batch(self, idxs: t.Sequence[int]) -> t.Optional[Sample]:
        """The dataset's batched load at the translated indices; None when
        it has none."""
        inner = getattr(self.dataset, "load_batch", None)
        if inner is None:
            return None
        return inner([self.indices[i] for i in idxs])
