"""Exported programs (``serving.export_model`` / ``load_exported``, the
counterparts of the JAX package's ``jax.export`` pair) and the operators
they keep: ``torch.ops.vmtl.fused_attention_gate`` (kernel B1) and
``torch.ops.vmtl.conv3x3_small`` (kernel B3). On the CPU each operator runs
its kernel's plain version; the CUDA side is in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from vision_mtl_tpu_torch.kernels import fused_gate, small_conv
from vision_mtl_tpu_torch.models.basic import BasicMTLModel
from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet
from vision_mtl_tpu_torch.serving import Predictor, export_model, load_exported

TASKS = {"depth": 1, "segm": 5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _vmtl_nodes(program):
    return [str(n.target) for n in program.graph.nodes if str(n.target).startswith("vmtl.")]


@pytest.mark.parametrize(
    "name, wire, op, calls",
    [("mtan", np.float32, "vmtl.fused_attention_gate.default", 8),
     ("basic", np.uint8, "vmtl.conv3x3_small.default", 10)],
)
def test_exported_program_equals_predict(name, wire, op, calls, tmp_path, monkeypatch):
    """``export_model`` then ``load_exported`` gives ``Predictor``'s answer;
    the graph holds the kernel's operator at each of its calls (MTAN's gates:
    2 levels, 2 tasks, encoder and decoder; the basic model's small 3x3
    convs: at decoder width 32 every decoder conv but the first two, and the
    merged head), and the loaded program runs the operator that many times,
    counted at its CPU kernel. (``chip_smoke.py`` loads its exports in a
    fresh process on the card and counts the launches.)"""
    if name == "mtan":
        model = MTANMiniUnet(TASKS, task_subnets_hidden_channels=16, encoder_first_channel=8,
                             encoder_num_channels=2, dtype=torch.float32, seed=4)
        hw = (16, 24)
    else:
        model = BasicMTLModel(5, decoder_first_channel=32, dtype=torch.float32, seed=4)
        hw = (32, 32)
    path = str(tmp_path / f"{name}.pt2")
    program = export_model(model, 2, *hw, path, dtype=wire, device="cpu")
    assert _vmtl_nodes(program) == [op] * calls
    rng = np.random.default_rng(5)
    imgs = (rng.integers(0, 256, size=(2, *hw, 3)).astype(np.uint8) if wire == np.uint8
            else rng.uniform(size=(2, *hw, 3)).astype(np.float32))
    want = Predictor(model, 2, *hw, dtype=wire, device="cpu")(imgs)

    fn = load_exported(path)
    module = fused_gate if name == "mtan" else small_conv
    kernel = op.split(".")[1]
    plain = getattr(module, f"{kernel}_plain")
    ran = []
    monkeypatch.setattr(module, f"{kernel}_plain", lambda *a: ran.append(1) or plain(*a))
    got = fn(imgs)
    assert len(ran) == calls
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_export_takes_what_predictor_takes(tmp_path, monkeypatch):
    """As ``Predictor``: a model in train mode or elsewhere than the device
    is refused, and the device defaults to the card."""
    model = MTANMiniUnet(TASKS, task_subnets_hidden_channels=8, encoder_first_channel=8,
                         encoder_num_channels=1, dtype=torch.float32)
    with pytest.raises(ValueError, match="eval"):
        export_model(model.train(), 1, 8, 8, str(tmp_path / "a.pt2"), device="cpu")
    with pytest.raises(ValueError, match="move the model"):
        export_model(model.eval(), 1, 8, 8, str(tmp_path / "a.pt2"), device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_model(model, 1, 8, 8, str(tmp_path / "a.pt2"))
    assert not (tmp_path / "a.pt2").exists()


@pytest.mark.parametrize("kernel", ["fused_attention_gate", "conv3x3_small"])
def test_operators_pass_opcheck(kernel):
    """``torch.library.opcheck`` on the CPU: the schema, the fake version's
    shapes, dtypes and strides against the real output, and tracing."""
    g = torch.Generator().manual_seed(0)
    if kernel == "fused_attention_gate":
        op = torch.ops.vmtl.fused_attention_gate.default
        cases = [
            (torch.randn(2, 3, 5, 7, generator=g), torch.randn(2, 3, 5, 12, generator=g),
             torch.randn(7, 16, generator=g), torch.randn(16, generator=g),
             torch.randn(16, 12, generator=g), torch.randn(12, generator=g)),
            tuple(a.bfloat16() if i < 2 else a for i, a in enumerate(
                (torch.randn(1, 4, 4, 3, generator=g), torch.randn(1, 4, 4, 8, generator=g),
                 torch.randn(3, 8, generator=g), torch.randn(8, generator=g),
                 torch.randn(8, 8, generator=g), torch.randn(8, generator=g)))),
        ]
    else:
        op = torch.ops.vmtl.conv3x3_small.default
        k = torch.randn(3, 3, 6, 5, generator=g)
        cases = [
            (torch.randn(2, 5, 7, 6, generator=g), k, torch.randn(5, generator=g)),
            (torch.randn(1, 4, 4, 5, generator=g).bfloat16(), k.flip(0, 1).transpose(2, 3),
             None),
        ]
    for args in cases:
        torch.library.opcheck(op, args)
    # the wrappers call the operators; they run the plain versions here
    module = fused_gate if kernel == "fused_attention_gate" else small_conv
    plain = getattr(module, f"{kernel}_plain")
    wrapper = getattr(module, kernel)
    before = module.launches.value
    for args in cases:
        torch.testing.assert_close(wrapper(*args), plain(*args), rtol=0, atol=0)
    assert module.launches.value == before


def test_gate_operator_has_no_backward():
    """The eval gate's operator is for inference: its forward takes inputs
    that require grad, and a backward through it raises instead of leaving
    them without a gradient."""
    g = torch.Generator().manual_seed(1)
    args = [torch.randn(1, 2, 3, 5, generator=g), torch.randn(1, 2, 3, 8, generator=g),
            torch.randn(5, 8, generator=g), torch.randn(8, generator=g),
            torch.randn(8, 8, generator=g), torch.randn(8, generator=g)]
    args = [a.requires_grad_() for a in args]
    out = fused_gate.fused_attention_gate(*args)
    torch.testing.assert_close(out, fused_gate.fused_attention_gate_plain(*args))
    with pytest.raises(RuntimeError, match="no backward"):
        out.sum().backward()
    with torch.inference_mode():
        assert not fused_gate.fused_attention_gate(*args).requires_grad
