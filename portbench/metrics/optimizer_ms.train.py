"""The device's milliseconds a train step in Adam's step
(``train.optimizer``): the CUDA events of the program's span, recorded on
the step's stream at its start and end (``train/step.make_train_step``),
over the traced sub-window's steps (``portbench/spans.py``)."""

from portbench import spans

UNIT, LAYER, MOVES = "ms", "train step", "train_img_per_s"


def read(r):
    return spans.device_ms_per_step(r, "train.optimizer")
