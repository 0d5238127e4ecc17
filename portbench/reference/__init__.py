"""The plain reference: each configuration's model, its losses, one Adam
training step and the served outputs, in plain PyTorch. Nothing here
imports the program under test."""

from __future__ import annotations

import typing as t

from torch import nn

from portbench.reference.common import F32, Precision


def build(config: t.Mapping[str, t.Any], precision: Precision = F32) -> nn.Module:
    """The configuration's reference model, its parameters uninitialised
    (``portbench.seeded.fill``); built on the current default device."""
    arch = config["architecture"]
    classes = config["num_classes"]
    if config["model"] == "mtan":
        from portbench.reference.mtan import MTAN

        return MTAN({"depth": 1, "segm": classes}, arch["encoder_first_channel"],
                    arch["encoder_num_channels"], arch["task_subnets_hidden_channels"],
                    precision=precision)
    if config["model"] == "basic":
        from portbench.reference.basic import Basic

        return Basic(classes, arch["decoder_first_channel"], arch["num_decoder_layers"],
                     precision=precision)
    raise ValueError(f"no reference for model {config['model']!r}")
