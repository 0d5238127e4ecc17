"""The port's evaluation harness on the CPU: its table, CSV and baseline
deltas equal the JAX package's (pandas) on the same results,
``evaluate_run`` on a port run dir gives the predict sweep's metrics, and
``--from_registry`` refuses an empty registry and a JAX checkpoint."""

import math
import sys

import pytest
import torch

from vision_mtl_tpu import eval_harness as jax_harness
from vision_mtl_tpu_torch import eval_harness
from vision_mtl_tpu_torch.cfg import fetch_data_cfg
from vision_mtl_tpu_torch.data import datamodule, synthetic
from vision_mtl_tpu_torch.pipeline import model_from_args
from vision_mtl_tpu_torch.predict import predict
from vision_mtl_tpu_torch.train import checkpoint
from vision_mtl_tpu_torch.train.plateau import ReduceLROnPlateau
from vision_mtl_tpu_torch.train.state import create_train_state
from vision_mtl_tpu_torch.utils.args import parse_args

RESULTS = {
    "basic": {"loss": 4.89251, "accuracy": 0.51149, "jaccard_index": 0.2265,
              "fbeta_score": 0.5005, "mae": 0.04949, "loss_segm": 2.0},
    "basic:tuned": {"loss": 6.0, "accuracy": 0.3295, "jaccard_index": 0.1095,
                    "fbeta_score": 0.30749, "mae": 0.079},
    "basic_p": {"loss": 4.9045, "accuracy": 0.5, "jaccard_index": 0.2222,
                "fbeta_score": 0.496, "mae": 0.0505},
    "mtan": {"loss": 5.7595, "accuracy": 0.50149, "jaccard_index": 0.2225,
             "fbeta_score": 0.48351},  # no mae
    "csnet": {"loss": 5.978, "accuracy": 0.411, "jaccard_index": 0.136,
              "fbeta_score": 0.3665, "mae": 0.083},
}
TAG_TO_MODEL = {"basic": "basic", "basic:tuned": "basic", "basic_p": "basic", "mtan": "mtan",
                "csnet": "csnet"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same(got, df):
    """The port's dict of dicts against a pandas frame: the same rows in
    order, the same columns, the same numbers (NaN where NaN)."""
    assert list(got) == list(df.index)
    for m in df.index:
        assert list(got[m]) == list(df.columns), m
        for tag in df.columns:
            want = float(df.loc[m, tag])
            assert (math.isnan(got[m][tag]) and math.isnan(want)) or got[m][tag] == want, (m, tag)


@pytest.mark.parametrize("dataset", ["nyuv2", "cityscapes", "synthetic"])
def test_table_and_baseline_deltas_match_jax(dataset, tmp_path):
    got = eval_harness.build_table(RESULTS)
    want = jax_harness.build_table(RESULTS)
    _same(got, want)
    eval_harness.write_csv(got, str(tmp_path / "port.csv"))
    want.to_csv(tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    got_cmp = eval_harness.compare_to_baseline(got, dataset, TAG_TO_MODEL)
    want_cmp = jax_harness.compare_to_baseline(want, dataset, TAG_TO_MODEL)
    if dataset == "synthetic":
        assert got_cmp is None and want_cmp is None
        return
    _same(got_cmp, want_cmp)
    assert list(got_cmp["loss"]) == ["basic vs HS", "basic:tuned vs HS tuned",
                                     "basic_p vs HS (P)", "mtan vs MTAN", "csnet vs CSNet"]
    assert eval_harness.REFERENCE_BASELINES == jax_harness.REFERENCE_BASELINES
    print(eval_harness.format_table(got_cmp))


def test_evaluate_run_equals_predict(tmp_path, monkeypatch, capsys):
    """A run dir of the full-width basic model (seeded weights, one
    checkpoint, train_args.yaml) on a tiny synthetic set: ``evaluate_run``
    gives the metrics of ``predict`` over the same holdout loader; ``main``
    prints and writes that table; ``--from_registry`` exits naming its
    ROADMAP item."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for k, v in dict(height=32, width=32, num_train=4, num_val=3).items():
        monkeypatch.setattr(synthetic.synthetic_data_cfg, k, v)
    run_dir = tmp_path / "version_0"
    run_dir.mkdir()
    args = parse_args(["--model_name", "basic", "--dataset_name", "synthetic",
                       "--loss_depth_weight", "0.5", "--device", "cpu"])
    data_cfg = fetch_data_cfg("synthetic")
    model = model_from_args(args, data_cfg, "cpu")
    state = create_train_state(model, 1e-3, device="cpu")
    checkpoint.save_ckpt(state, ReduceLROnPlateau(), 0, str(run_dir))
    checkpoint.log_args(args, str(run_dir / "train_args.yaml"))

    dm = datamodule.MTLDataModule("synthetic", batch_size=2)
    dm.setup(stage="predict")
    _, want = predict(dm.predict_dataloader(), model.eval(), data_cfg.num_classes,
                      loss_depth_weight=0.5, device="cpu")
    got = eval_harness.evaluate_run("basic", str(run_dir), "synthetic", batch_size=2,
                                    device="cpu")
    assert got == {k.replace("predict/", ""): v for k, v in want.items()}
    assert len(got) == 7

    out_csv = tmp_path / "table.csv"
    eval_harness.main(["--dataset_name", "synthetic", "--batch_size", "2", "--device", "cpu",
                       "--runs", f"basic:seeded={run_dir}", "--out", str(out_csv),
                       "--compare_baseline"])
    out = capsys.readouterr().out
    assert "(no reference baseline table for this dataset)" in out
    table = eval_harness.build_table({"seeded": got})
    assert out_csv.read_text().splitlines()[0] == ",seeded"
    assert eval_harness.format_table(table) in out
    empty = str(tmp_path / "run_registry.json")
    with pytest.raises(SystemExit) as e:
        eval_harness.main(["--from_registry", "--registry", empty, "--dataset_name", "synthetic",
                           "--device", "cpu"])
    assert e.value.code == (
        "no registered runs for dataset 'synthetic' — train something first (training.main "
        "registers runs on completion) or pass --runs explicitly.")
    with pytest.raises(SystemExit, match="duplicate tag"):
        eval_harness.main(["--device", "cpu", "--dataset_name", "synthetic",
                           "--runs", f"basic={run_dir}", f"basic={run_dir}"])


def test_from_registry_refuses_a_jax_checkpoint(tmp_path, capsys):
    """A registered run dir (registered by the JAX package) whose
    ``model_{e}/`` directories are Orbax checkpoints, with no ``model.pt``,
    stops the harness before any run loads, naming the directory."""
    from vision_mtl_tpu.tracking import artifacts as jax_artifacts

    run = tmp_path / "jax_run"
    (run / "model_3" / "d").mkdir(parents=True)
    (run / "model_3" / "manifest.ocdbt").write_bytes(b"")
    (run / "session_3").mkdir()
    registry = str(tmp_path / "run_registry.json")
    jax_artifacts.register_run("mtan", "synthetic", str(run), path=registry)
    with pytest.raises(SystemExit) as e:
        eval_harness.main(["--from_registry", "--registry", registry, "--dataset_name",
                           "synthetic", "--device", "cpu"])
    assert str(e.value.code).startswith(f"{run}: a JAX (Orbax) checkpoint")
    assert "Evaluating" not in capsys.readouterr().out
