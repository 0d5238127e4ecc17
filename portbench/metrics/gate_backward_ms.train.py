"""The device's milliseconds a train step in B4's backward, the PyTorch
operations of ``_FusedGateTrain.backward`` (``kernels/fused_gate_train.py``):
the CUDA events of the program's ``gate.backward`` span, one a gate and task,
over the traced sub-window's steps (``portbench/spans.py``)."""

from portbench import spans

UNIT, LAYER, MOVES = "ms", "B4 train gate", "train_img_per_s"


def read(r):
    shapes = r.config.get("gate_shapes")
    if not shapes:
        return None
    return spans.device_ms_per_step(r, "gate.backward", len(shapes) * r.config["tasks"])
