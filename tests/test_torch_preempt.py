"""Preemption in the port on the CPU (after the JAX package's
tests/test_preempt.py): the guard, its signal and its injection; a run
preempted mid-epoch, or during validation, and resumed ends bit for bit
where the uninterrupted run does (weights, Adam's state, metrics, batch
order); ``resolve_resume`` takes the newest checkpoint; and the CLI exits
143 under ``--preempt_save`` and resumes with ``--resume_dir`` or
``--auto_resume``."""

import argparse
import json
import os
import signal
import sys
import time

import pytest
import torch

from vision_mtl_tpu_torch import training
from vision_mtl_tpu_torch.cfg import cfg
from vision_mtl_tpu_torch.data import datamodule, loader, synthetic
from vision_mtl_tpu_torch.metrics import init_metrics
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
from vision_mtl_tpu_torch.train import checkpoint
from vision_mtl_tpu_torch.train.loop import run_pipe
from vision_mtl_tpu_torch.train.plateau import ReduceLROnPlateau
from vision_mtl_tpu_torch.train.preempt import PreemptionGuard
from vision_mtl_tpu_torch.train.state import create_train_state

NC = 5
# 16 train samples: 12 for training (3 steps of 4), 4 held out (1 val step)
TINY = dict(height=16, width=24, num_classes=NC, num_train=16, num_val=4)
ARGS = argparse.Namespace(
    loss_segm_weight=1.0, loss_depth_weight=1.0, val_epoch_freq=1, save_epoch_freq=10,
    grad_accum_steps=1, keep_ckpt_last_k=0,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _restore_sigterm():
    """A guard installs a SIGTERM handler it never removes; without this
    the rest of the suite would ignore SIGTERM."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


@pytest.fixture
def tiny_synthetic(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setattr(synthetic.synthetic_data_cfg, k, v)


class _Logger:
    def __init__(self, log_dir):
        self.log_dir = str(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)

    def log_metrics(self, *a, **k):
        pass


class _CountingGuard:
    """Fires at the Nth poll: pins the request to one place in the loop
    (a validation step, which a step count cannot reach)."""

    def __init__(self, fire_at_poll):
        self.polls, self.fire_at = 0, fire_at_poll

    def requested(self, step):
        self.polls += 1
        return self.polls >= self.fire_at


def _state(lr=3e-3, seed=0):
    model = MTANMiniUnet({"depth": 1, "segm": NC}, task_subnets_hidden_channels=8,
                         encoder_first_channel=8, encoder_num_channels=2,
                         dtype=torch.float32, seed=seed)
    return create_train_state(model, lr, device="cpu")


def _dm():
    dm = datamodule.MTLDataModule("synthetic", batch_size=4, seed=11)
    dm.setup()
    return dm


def _bits(state):
    out = {f"model.{k}": v.detach().clone() for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            out[f"adam.{i}.{k}"] = v.detach().clone()
    return out


def _assert_same_run(got_state, got_metrics, want_state, want_metrics, whole=False):
    assert got_state.step == want_state.step
    got, want = _bits(got_state), _bits(want_state)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for stage in ("train", "val"):
        assert got_metrics[stage].keys() == want_metrics[stage].keys()
        for k, v in want_metrics[stage].items():
            # the resumed run reports the epochs it ran: the last one, or all
            assert (got_metrics[stage][k] if whole else got_metrics[stage][k][-1:]) == \
                (v if whole else v[-1:]), f"{stage}/{k}"


def test_guard_injection_and_signal(monkeypatch):
    g = PreemptionGuard(inject_at_step=5)
    assert not g.requested(4)
    assert g.requested(5) and g.requested(6)
    monkeypatch.setenv("VMTL_PREEMPT_AT_STEP", "3")
    g = PreemptionGuard()
    assert not g.requested(2) and g.requested(3)
    monkeypatch.delenv("VMTL_PREEMPT_AT_STEP")
    g = PreemptionGuard()
    assert not g.requested(0)
    os.kill(os.getpid(), signal.SIGTERM)
    deadline = time.time() + 5.0
    while not g.requested(0) and time.time() < deadline:
        time.sleep(0.01)
    assert g.requested(0)


@pytest.mark.parametrize("where", ["train", "val"])
def test_preempt_and_resume_exactly(tiny_synthetic, tmp_path, monkeypatch, where):
    """Two epochs straight against a run preempted two steps into its
    second epoch (or at its first validation step) and resumed from the
    preemption checkpoint into a model of other weights: the weights, Adam's
    moments and steps, the step counter, the interrupted epoch's metrics
    and the batch order are equal bit for bit."""
    orders = []
    index_batches = loader.DataLoader._index_batches

    def record(self):
        batches = index_batches(self)
        if self.shuffle:
            orders.append([b.tolist() for b in batches[self.skip_batches:]])
        return batches

    monkeypatch.setattr(loader.DataLoader, "_index_batches", record)
    state_a, metrics_a = run_pipe(ARGS, _state(), _dm(), 2, NC, logger=_Logger(tmp_path / "a"),
                                  device="cpu")
    orders_a, orders[:] = list(orders), []
    n_train = len(_dm().train_dataloader())
    assert n_train == 3

    # train: polls 1..3 in epoch 0, then the tail poll, then 2 steps into
    # epoch 1; val: the first validation poll of epoch 0
    guard = PreemptionGuard(inject_at_step=n_train + 2) if where == "train" else \
        _CountingGuard(n_train + 1)
    ckpt = tmp_path / "b"
    with pytest.raises(SystemExit) as exc:
        run_pipe(ARGS, _state(), _dm(), 2, NC, logger=_Logger(ckpt), preempt_guard=guard,
                 device="cpu")
    assert exc.value.code == 143
    assert checkpoint.resolve_resume(str(ckpt)) == "preempt"
    assert sorted(os.listdir(ckpt)) == ["preempt_meta.json", "preempt_model", "preempt_session"]

    sched = ReduceLROnPlateau(patience=2, factor=0.9)
    state, sched, epoch, batch, mstate, val_step = checkpoint.restore_preempt(
        _state(lr=1.0, seed=3), sched, str(ckpt), NC)
    want_pos = (1, 2, 1) if where == "train" else (0, n_train, 0)
    assert (epoch, batch, val_step) == want_pos
    assert json.load(open(ckpt / "preempt_meta.json")) == {"epoch": epoch,
                                                           "batch_in_epoch": batch}
    orders[:] = []
    state_b, metrics_b = run_pipe(ARGS, state, _dm(), 2, NC, logger=_Logger(tmp_path / "b2"),
                                  scheduler=sched, start_epoch=epoch, start_batch=batch,
                                  initial_train_mstate=mstate, start_val_step=val_step,
                                  device="cpu")
    assert orders == [o[batch:] if i == 0 else o for i, o in enumerate(orders_a[epoch:])]
    _assert_same_run(state_b, metrics_b, state_a, metrics_a, whole=where == "val")


def test_preempt_at_epoch_end_saves_an_epoch_checkpoint(tiny_synthetic, tmp_path):
    """A request after the epoch's last validation poll is honoured with an
    epoch checkpoint: the epoch, its scheduler step included, is complete,
    and the resume at the next epoch ends where the straight run does."""
    state_a, metrics_a = run_pipe(ARGS, _state(), _dm(), 2, NC, device="cpu")
    ckpt = tmp_path / "b"
    with pytest.raises(SystemExit) as exc:
        run_pipe(ARGS, _state(), _dm(), 2, NC, logger=_Logger(ckpt), device="cpu",
                 preempt_guard=_CountingGuard(3 + 1 + 1))  # 3 train, 1 val, the tail
    assert exc.value.code == 143
    assert sorted(os.listdir(ckpt)) == ["model_0", "session_0"]
    assert checkpoint.resolve_resume(str(ckpt)) == "epoch"
    sched = ReduceLROnPlateau(patience=2, factor=0.9)
    state, sched, start = checkpoint.restore_session(_state(seed=4), sched, str(ckpt))
    state_b, metrics_b = run_pipe(ARGS, state, _dm(), 2, NC, scheduler=sched, start_epoch=start,
                                  device="cpu")
    _assert_same_run(state_b, metrics_b, state_a, metrics_a)


def test_resolve_resume_prefers_the_newest(tmp_path):
    """A preemption checkpoint loses to later epoch checkpoints and wins
    over older ones; an unreadable sidecar falls back to the epoch ones;
    ``--auto_resume`` finds a run that holds only a preemption checkpoint."""
    state, sched = _state(), ReduceLROnPlateau()
    assert checkpoint.resolve_resume(str(tmp_path)) == "epoch"
    checkpoint.save_preempt_ckpt(state, sched, 1, 2, init_metrics(NC, "cpu"), 4, str(tmp_path))
    assert checkpoint.resolve_resume(str(tmp_path)) == "preempt"
    checkpoint.save_ckpt(state, sched, 0, str(tmp_path))
    assert checkpoint.resolve_resume(str(tmp_path)) == "preempt"  # (1, 2) > (1, 0)
    checkpoint.save_ckpt(state, sched, 3, str(tmp_path))
    assert checkpoint.resolve_resume(str(tmp_path)) == "epoch"
    checkpoint.save_preempt_ckpt(state, sched, 4, 1, init_metrics(NC, "cpu"), 8, str(tmp_path))
    assert checkpoint.resolve_resume(str(tmp_path)) == "preempt"
    (tmp_path / "preempt_meta.json").write_text("{trunc")
    assert checkpoint.resolve_resume(str(tmp_path)) == "epoch"
    base = tmp_path / "runs" / "training-mtan"
    nested = base / "a_run" / "version_0"
    os.makedirs(nested)
    assert checkpoint.find_latest_resumable_run(str(base)) is None
    checkpoint.save_preempt_ckpt(state, sched, 0, 1, init_metrics(NC, "cpu"), 0, str(nested))
    assert checkpoint.find_latest_resumable_run(str(base)) == str(nested)
    with pytest.raises(ValueError, match="classes"):
        checkpoint.restore_preempt(_state(), ReduceLROnPlateau(), str(nested), NC + 1)


def test_cli_preempt_and_resume(tiny_synthetic, tmp_path, monkeypatch):
    """``training.main`` at the full MTAN width: with ``--preempt_save`` and
    an injected request one step into its second epoch it exits 143 with a
    preemption checkpoint; ``--auto_resume`` finds that run and trains to
    the end; its last checkpoint's weights equal an uninterrupted run's bit
    for bit."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(synthetic.synthetic_data_cfg, "height", 16)
    monkeypatch.setattr(synthetic.synthetic_data_cfg, "width", 16)
    monkeypatch.setattr(synthetic.synthetic_data_cfg, "num_train", 5)
    monkeypatch.setattr(synthetic.synthetic_data_cfg, "num_val", 2)
    argv = ["--device", "cpu", "--dataset_name", "synthetic", "--model_name", "mtan",
            "--batch_size", "2", "--num_epochs", "2", "--precision", "f32"]
    monkeypatch.setattr(cfg, "log_root_dir", tmp_path / "straight")
    straight = training.main(argv)
    monkeypatch.setattr(cfg, "log_root_dir", tmp_path)
    monkeypatch.setenv("VMTL_PREEMPT_AT_STEP", "3")  # 2 steps an epoch
    with pytest.raises(SystemExit) as exc:
        training.main(argv + ["--preempt_save"])
    assert exc.value.code == 143
    monkeypatch.delenv("VMTL_PREEMPT_AT_STEP")
    preempted = str(tmp_path / "training-mtan" / "version_0")
    assert {"preempt_model", "preempt_session", "preempt_meta.json"} <= set(os.listdir(preempted))
    assert checkpoint.resolve_resume(preempted) == "preempt"
    resumed = training.main(argv + ["--auto_resume"])
    assert resumed == str(tmp_path / "training-mtan" / "version_1")
    records = [json.loads(ln) for ln in open(os.path.join(resumed, "metrics.jsonl"))]
    assert [r["step"] for r in records if "step/train/loss" in r] == [3]
    want = checkpoint.load_ckpt_model(straight, 1)
    got = checkpoint.load_ckpt_model(resumed, 1)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
