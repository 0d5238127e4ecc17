"""The four remat flags on the CPU, on each model that has them: MTAN's
``remat_attention`` (unfolded and with ``fold_tasks``) and ``remat_shared``,
basic's and CSNet's ``remat_tail`` and ``remat_encoder``. For each: the
parameter and buffer trees are those of the model without remat; one train
step (``make_train_step``) equals the same step without remat bit for bit,
the loss, every gradient and every running statistic (the recompute in the
backward pass runs the blocks' forwards again, and must not fold the batch
into the running statistics a second time); the rematerialised blocks
really run twice in the step; the eval output is unchanged. JAX's own remat
is transparent and the port's unremat steps are held to JAX elsewhere, so
no JAX run is needed here."""

import numpy as np
import pytest
import torch

from vision_mtl_tpu_torch.metrics import init_metrics
from vision_mtl_tpu_torch.models import blocks
from vision_mtl_tpu_torch.models.basic import BasicMTLModel
from vision_mtl_tpu_torch.models.cross_stitch import CSNet
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
from vision_mtl_tpu_torch.train.state import create_train_state
from vision_mtl_tpu_torch.train.step import make_train_step

NC = 5
TASKS = {"depth": 1, "segm": NC}


def _mtan(**opts):
    return MTANMiniUnet(TASKS, task_subnets_hidden_channels=16, encoder_first_channel=8,
                        encoder_num_channels=3, dtype=torch.float32, seed=1, **opts)


def _basic(**opts):
    return BasicMTLModel(NC, decoder_first_channel=16, dtype=torch.float32, seed=1, **opts)


def _csnet(**opts):
    return CSNet(TASKS, decoder_first_channel=16, dtype=torch.float32, seed=1, **opts)


# (model, the options without remat, the remat options, a module that the
# remat options rematerialise)
CASES = {
    "mtan-remat_attention": (_mtan, {}, {"remat_attention": True}, "enc_attn_1_task0"),
    "mtan-remat_attention-fold_tasks": (
        _mtan, {"fold_tasks": True}, {"fold_tasks": True, "remat_attention": True},
        "dec_attn_0_folded"),
    "mtan-remat_shared": (_mtan, {}, {"remat_shared": True}, "bottleneck"),
    "basic-remat_tail": (_basic, {}, {"remat_tail": 2}, "backbone.decoder.block_3"),
    "basic-remat_encoder": (_basic, {}, {"remat_encoder": True},
                            "backbone.encoder.stages_2_1"),
    "csnet-remat_encoder": (_csnet, {}, {"remat_encoder": True}, "encoders_1.stages_3_0"),
    "csnet-remat_tail": (_csnet, {}, {"remat_tail": 2}, "decoders_0_4"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(hw):
    rng = np.random.default_rng(4)
    return {
        "img": torch.from_numpy(rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)),
        "mask": torch.from_numpy(rng.integers(0, NC, (2, *hw)).astype(np.int32)),
        "depth": torch.from_numpy(rng.uniform(0.1, 1, (2, *hw, 1)).astype(np.float32)),
    }


def _step(model, batch, watched):
    calls = []
    handle = model.get_submodule(watched).register_forward_pre_hook(lambda *_: calls.append(1))
    state = create_train_state(model, 1e-3, device="cpu")
    _, _, losses = make_train_step(device="cpu")(state, batch, init_metrics(NC, "cpu"))
    handle.remove()
    return {
        "loss": losses["loss"],
        "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
        "buffers": {k: b.clone() for k, b in model.named_buffers()},
        "calls": len(calls),
    }


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Both models of a case, built from one seed, and their train steps."""
    make, plain_opts, remat_opts, watched = CASES[request.param]
    hw = (32, 32)
    batch = _batch(hw)
    plain, remat = make(**plain_opts), make(**remat_opts)
    states = {k: v.clone() for k, v in plain.state_dict().items()}
    out = {"plain": plain, "remat": remat, "before": states, "batch": batch}
    out["plain_step"] = _step(plain, batch, watched)
    out["remat_step"] = _step(remat, batch, watched)
    return out


def test_remat_keeps_the_parameter_and_buffer_trees(case):
    plain = {k: (v.shape, v.dtype) for k, v in case["before"].items()}
    remat = {k: (v.shape, v.dtype) for k, v in case["remat"].state_dict().items()}
    assert remat == plain


def test_remat_train_step_equals_the_plain_step_bit_for_bit(case):
    plain, remat = case["plain_step"], case["remat_step"]
    assert torch.equal(remat["loss"], plain["loss"])
    assert remat["grads"].keys() == plain["grads"].keys()
    for k, g in plain["grads"].items():
        assert torch.equal(remat["grads"][k], g), k
    for k, b in plain["buffers"].items():  # each batch counted once
        assert torch.equal(remat["buffers"][k], b), k
    moved = [k for k, b in plain["buffers"].items() if not torch.equal(b, case["before"][k])]
    assert moved  # the step did update running statistics


def test_remat_recomputes_in_the_backward_pass(case):
    """The watched block was entered once in the plain step and twice
    (forward and recompute; the recompute stops once it has what the
    backward needs, so a pre-hook counts it) in the remat step."""
    assert case["plain_step"]["calls"] == 1
    assert case["remat_step"]["calls"] == 2


def test_remat_eval_output_is_unchanged(case):
    x = case["batch"]["img"]
    with torch.no_grad():
        want = case["plain"].eval()(x)
        got = case["remat"].eval()(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_recompute_leaves_running_statistics_alone():
    """The switch itself: under the recompute context a BatchNorm still
    normalises with the batch statistics and leaves its running ones."""
    bn = blocks.BatchNorm(4).train()
    x = torch.randn(2, 3, 3, 4)
    before = bn.running_mean.clone(), bn.running_var.clone()
    with blocks._recomputing():
        y = bn(x)
    assert torch.equal(bn.running_mean, before[0]) and torch.equal(bn.running_var, before[1])
    assert torch.equal(y, bn(x))
    assert not torch.equal(bn.running_mean, before[0])
