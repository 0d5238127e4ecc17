"""The plain reference: each configuration's model, its losses, one Adam
training step and the served outputs, in plain PyTorch. Nothing here
imports the program under test.

A model's reference is the module named after it, ``<model>.py`` here,
with ``build(config, precision)``: a new model is a new file."""

from __future__ import annotations

import importlib
import re
import typing as t
from pathlib import Path

from torch import nn

from portbench.reference.common import F32, Precision

#: a model's name: one of the benchmark's names (at most 64 characters)
#: that is also a Python module's, since it names ``reference/<model>.py``
NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]{0,63}")


def build(config: t.Mapping[str, t.Any], precision: Precision = F32) -> nn.Module:
    """The configuration's reference model, its parameters uninitialised
    (``portbench.seeded.weights`` draws them); built on the current default device by
    ``reference/<config["model"]>.py``'s ``build``."""
    model = config["model"]
    if not NAME.fullmatch(model):
        raise ValueError(f"model name {model!r} is not a name of at most 64 letters, digits "
                         f"and _ that does not start with a digit")
    path = Path(__file__).parent / f"{model}.py"
    if not path.is_file():
        raise ValueError(f"no reference for model {model!r}: "
                         f"no file portbench/reference/{model}.py")
    return importlib.import_module(f"portbench.reference.{model}").build(config, precision)
