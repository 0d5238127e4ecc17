"""Datamodule: dataset construction, the train/val split, the benchmark
batch and the loaders (counterpart of ``vision_mtl_tpu/data/datamodule.py``).

The split is a seeded permutation (``default_rng(seed)``, 0.8 train).
``do_overfit`` makes train = val = test = predict the first batch. Test
and predict read the "val" stage for Cityscapes and "test" for the others.
Under several ranks each loader decodes its rank's rows of every global
batch, or under the mesh's ``spatial`` or ``model`` axis the whole batch,
of which each rank keeps its block (:func:`configure_host_sharded_loading`).
"""

from __future__ import annotations

import typing as t

import numpy as np

from vision_mtl_tpu_torch.cfg import cfg, fetch_data_cfg
from vision_mtl_tpu_torch.data.base import MTLDataset, Subset
from vision_mtl_tpu_torch.data.loader import DataLoader


def _make_dataset(dataset_name: str, stage: str, transforms: t.Any) -> MTLDataset:
    if dataset_name == "cityscapes":
        from vision_mtl_tpu_torch.data.cityscapes import CityscapesDataset

        return CityscapesDataset(stage=stage, transforms=transforms)
    if dataset_name == "synthetic":
        from vision_mtl_tpu_torch.data.synthetic import SyntheticMTLDataset

        return SyntheticMTLDataset(stage=stage, transforms=transforms)
    if dataset_name == "nyuv2":
        from vision_mtl_tpu_torch.data.nyuv2 import NYUv2

        return NYUv2(stage=stage, transforms=transforms)
    raise ValueError(f"Unknown dataset name {dataset_name}")


def configure_host_sharded_loading(datamodule: t.Any, mesh: t.Any) -> None:
    """Pick the loaders' mode for ``mesh``, as the JAX package does:
    row-sliced (each rank decodes its rows of every global batch) when
    ``data`` is the one axis that spans processes; full-batch
    (``shard_rows`` False: every rank decodes the whole global batch and
    keeps its block, ``parallel.mesh.local_batches``) when ``spatial`` or
    ``model`` spans them too (the ranks of a model group need the same
    block). A no-op without a mesh."""
    from vision_mtl_tpu_torch.parallel.mesh import process_spanning_axes

    spanning = set(process_spanning_axes(mesh)) - {"data"}
    if datamodule is not None:
        datamodule.shard_rows = not spanning


class MTLDataModule:
    def __init__(
        self,
        dataset_name: str,
        train_transform: t.Any = None,
        test_transform: t.Any = None,
        train_size: float = 0.8,
        batch_size: int = 4,
        num_workers: int = 0,
        shuffle_train: bool = True,
        do_overfit: bool = False,
        seed: t.Optional[int] = None,
        wire_format: t.Optional[str] = None,
    ):
        self.wire_format = wire_format or fetch_data_cfg(dataset_name).wire_format
        self.dataset_name = dataset_name
        self.train_transform = train_transform
        self.test_transform = test_transform
        self.train_size = train_size
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.shuffle_train = shuffle_train
        self.do_overfit = do_overfit
        self.seed = cfg.seed if seed is None else seed

        self.data_train: t.Any = None
        self.data_val: t.Any = None
        self.data_test: t.Any = None
        self.data_predict: t.Any = None
        self.benchmark_batch: t.Optional[t.Dict[str, np.ndarray]] = None
        #: each rank decodes its rows of a global batch (False: all of it)
        self.shard_rows = True

    def setup(self, stage: t.Optional[str] = None) -> None:
        data_train = _make_dataset(self.dataset_name, "train", self.train_transform)
        try:
            self.benchmark_batch = data_train.load_benchmark_batch()
        except (IndexError, OSError, ValueError) as e:
            # the fixed benchmark ids may lie beyond a small tree: report
            # and go on without the batch, as the JAX package does
            print("Failed to load benchmark batch: ", e)
            self.benchmark_batch = None

        if stage in ("fit", None) or (self.do_overfit and self.data_train is None):
            if self.do_overfit:
                overfit = Subset(data_train, range(self.batch_size))
                self.data_train = self.data_val = overfit
            else:
                n = len(data_train)
                train_len = int(n * self.train_size)
                order = np.random.default_rng(self.seed).permutation(n)
                self.data_train = Subset(data_train, order[:train_len])
                # val reads the same stage through the test transform: a
                # second dataset instance over the held-out indices
                data_eval = _make_dataset(self.dataset_name, "train", self.test_transform)
                self.data_val = Subset(data_eval, order[train_len:])

        val_stage_name = "val" if self.dataset_name == "cityscapes" else "test"
        if stage in ("test", None):
            self.data_test = (
                self.data_train
                if self.do_overfit
                else _make_dataset(self.dataset_name, val_stage_name, self.test_transform)
            )
        if stage in ("predict", None):
            self.data_predict = (
                self.data_train
                if self.do_overfit
                else _make_dataset(self.dataset_name, val_stage_name, self.test_transform)
            )

    def train_dataloader(self) -> DataLoader:
        return DataLoader(
            self.data_train,
            batch_size=self.batch_size,
            shuffle=self.shuffle_train,
            seed=self.seed,
            drop_last=True,
            num_workers=self.num_workers,
            wire_format=self.wire_format,
            shard_rows=self.shard_rows,
        )

    def _eval_loader(self, dataset: t.Any) -> DataLoader:
        return DataLoader(
            dataset,
            batch_size=self.batch_size,
            shuffle=False,
            drop_last=False,
            pad_last=True,
            num_workers=self.num_workers,
            wire_format=self.wire_format,
            shard_rows=self.shard_rows,
        )

    def val_dataloader(self) -> DataLoader:
        return self._eval_loader(self.data_val)

    def test_dataloader(self) -> DataLoader:
        return self._eval_loader(self.data_test)

    def predict_dataloader(self) -> DataLoader:
        return self._eval_loader(self.data_predict)
