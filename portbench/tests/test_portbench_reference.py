"""The plain reference agrees with the port at a small size in float32:
the same seeded weights give the same forward, eval and train mode, and
the same first training step. Every configuration of ``BENCHMARK.json``,
the program's model built by ``harness.program_model``."""

from __future__ import annotations

import pytest
import torch

from portbench import compare, harness, reference, seeded
from portbench.reference.common import calibrate_
from portbench.reference.steps import decode, train_steps
from portbench.tests import tiny
from vision_mtl_tpu_torch.train.step import make_predict_step

CONFIGS = [c["name"] for c in harness.load_benchmark(tiny.ROOT)["configs"]]


def _models(name):
    # at 64 rows basic's stride-32 map is 2x4: at 32 its head BatchNorm would
    # see 4 values a channel, whose statistics amplify rounding
    cfg = tiny.config(name, height=64)
    weights = seeded.weights(cfg, tiny.SEED, torch.device("cpu"))
    ref = reference.build(cfg)
    ref.load_state_dict(weights)
    port = harness.program_model(cfg, "cpu", torch.float32)
    port.load_state_dict(weights)
    pool = seeded.train_pool(tiny.SEED, 1, 2, cfg["height"], cfg["width"], cfg["num_classes"],
                             torch.device("cpu"))
    return cfg, ref, port, pool


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_port(name):
    _, ref, port, pool = _models(name)
    img = decode(pool[0], torch.device("cpu"))["img"]
    calibrate_(ref, img)  # the served cell's statistics, also in the port
    port.load_state_dict(ref.state_dict())
    with torch.no_grad():  # eval first: the port's train mode moves its statistics
        for train in (False, True):
            ref.train(train)
            port.train(train)
            want, got = ref(img), port(img)
            for k in ("segm", "depth"):
                torch.testing.assert_close(got[k], want[k], rtol=2e-4, atol=2e-4)
            if not train:
                served = make_predict_step(port)(pool[0]["img"])
                agree = (served["segm"].long() == want["segm"].argmax(-1)).float().mean()
                assert agree > 0.999


@pytest.mark.parametrize("name", CONFIGS)
def test_first_train_step_matches_the_port(name):
    from vision_mtl_tpu_torch.metrics import init_metrics
    from vision_mtl_tpu_torch.train.state import create_train_state
    from vision_mtl_tpu_torch.train.step import make_train_step

    cfg, ref, port, pool = _models(name)
    classes = cfg["num_classes"]
    weights = {k: v.clone() for k, v in ref.state_dict().items()}
    want = train_steps(ref, pool, 0.005, 1.0, 1.0, classes, torch.device("cpu"))
    state = create_train_state(port, 0.005, device="cpu")
    named = dict(port.named_parameters())
    state, mstate, ls = make_train_step(device="cpu")(state, pool[0],
                                                      init_metrics(classes, "cpu"))
    got = {"loss": [float(ls["loss"])],
           "grad_norm": {k: float(v) for k, v in
                         compare.program_grad_norms(named, state.optimizer).items()},
           "change_norm": {k: float((p.detach() - weights[k]).norm()) for k, p in named.items()},
           "confmat": mstate.confmat}
    gaps, _ = compare.train_gaps(got, want)
    # float32 on both sides: the loss to rounding; a leaf's gradient norm
    # within 1e-4-1e-3 (basic's early encoder, whose gradients pass many
    # batch-statistic BatchNorms, each a cancelling sum, at batch 2)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap_median"] < 5e-4 and gaps["grad_gap"] < 5e-3
    assert gaps["update_gap_median"] < 5e-4
    assert gaps["confmat_gap"] < 1e-3
