"""MobileNetV3-Large encoder, NHWC (counterpart of
``vision_mtl_tpu/models/mobilenetv3.py``).

A conv stem (16 channels, /2, hardswish), six stages of depthwise-separable
and inverted-residual blocks with optional squeeze-excite, then a 1x1 conv
head to 960 channels. ``forward`` returns the 5-scale pyramid the Unet
decoder consumes, ``[x, f2, f4, f8, f16, f32]`` with (3, 16, 24, 40, 112,
960) channels. ``run_stem`` / ``run_stage`` / ``run_head`` expose the parts
one at a time for a caller that works between stages.

Submodule names are the flax names (``conv_stem``, ``_stem_bn``,
``stages_{i}_{j}``, ``conv_head``, ``_head_bn``; inside a block ``Conv_k``,
``BatchNorm_k``, ``SqueezeExcite_0`` numbered by type in creation order), so
``weights.load_jax_variables`` walks both trees side by side.

``remat=True`` rematerialises each inverted-residual block in the backward
pass (``blocks.checkpointed``): only the blocks' boundaries stay live for
the gradient. The parameters are the same either way.

Under the mesh's ``spatial`` axis each part runs at its level
(``parallel.halo.at_level``: the stem's output is level 1, each strided
block adds one, the head is at ``NUM_LEVELS``); a strided block that goes
down into the first level that runs whole takes the whole map
(``halo.from_finer``).
"""

from __future__ import annotations

import dataclasses
import math
import typing as t

import torch
from torch import nn

from vision_mtl_tpu_torch.models.blocks import (
    ACTIVATIONS,
    BatchNorm,
    Conv,
    RawBatchNorm,
    SqueezeExcite,
    checkpointed,
    make_divisible,
)
from vision_mtl_tpu_torch.parallel.halo import at_level, from_finer


@dataclasses.dataclass(frozen=True)
class IRSpec:
    """One inverted-residual (or depthwise-separable) block."""

    exp_ch: int
    out_ch: int
    kernel: int
    stride: int
    se: bool
    act: str
    ds: bool = False  # depthwise-separable (no expansion conv)


# mobilenetv3_large_100 stage table (width multiplier 1.0)
MOBILENETV3_LARGE_SPECS: t.Tuple[t.Tuple[IRSpec, ...], ...] = (
    (IRSpec(16, 16, 3, 1, False, "relu", ds=True),),
    (IRSpec(64, 24, 3, 2, False, "relu"), IRSpec(72, 24, 3, 1, False, "relu")),
    (
        IRSpec(72, 40, 5, 2, True, "relu"),
        IRSpec(120, 40, 5, 1, True, "relu"),
        IRSpec(120, 40, 5, 1, True, "relu"),
    ),
    (
        IRSpec(240, 80, 3, 2, False, "hardswish"),
        IRSpec(200, 80, 3, 1, False, "hardswish"),
        IRSpec(184, 80, 3, 1, False, "hardswish"),
        IRSpec(184, 80, 3, 1, False, "hardswish"),
    ),
    (
        IRSpec(480, 112, 3, 1, True, "hardswish"),
        IRSpec(672, 112, 3, 1, True, "hardswish"),
    ),
    (
        IRSpec(672, 160, 5, 2, True, "hardswish"),
        IRSpec(960, 160, 5, 1, True, "hardswish"),
        IRSpec(960, 160, 5, 1, True, "hardswish"),
    ),
)

STEM_CH = 16
CONV_HEAD_CH = 960
NUM_STAGES = len(MOBILENETV3_LARGE_SPECS)
# output channels of each stage: (16, 24, 40, 80, 112, 160)
STAGE_OUT_CHANNELS: t.Tuple[int, ...] = tuple(s[-1].out_ch for s in MOBILENETV3_LARGE_SPECS)
# encoder feature channels at strides (1, 2, 4, 8, 16, 32) for a depth-5 Unet
ENCODER_OUT_CHANNELS: t.Tuple[int, ...] = (3, 16, 24, 40, 112, 960)
#: the encoder's stride at its coarsest level: the stem's 2 times each stage's
#: (32)
ENCODER_STRIDE = 2 * math.prod(s.stride for stage in MOBILENETV3_LARGE_SPECS for s in stage)
#: the level (the times the rows have halved) of each stage's input: the
#: stem's output is level 1, each strided block goes one level down
STAGE_IN_LEVEL: t.Tuple[int, ...] = tuple(
    1 + sum(s.stride == 2 for stage in MOBILENETV3_LARGE_SPECS[:i] for s in stage)
    for i in range(len(MOBILENETV3_LARGE_SPECS))
)
#: the level of the conv head: the coarsest
NUM_LEVELS = int(math.log2(ENCODER_STRIDE))
# stages after which a pyramid tap is taken; the /32 tap is the conv head's
FEATURE_TAP_AFTER_STAGE: t.Tuple[int, ...] = (0, 1, 2, 4)


class InvertedResidual(nn.Module):
    """[1x1 expand -> BN -> act] -> kxk depthwise (strided) -> BN -> act ->
    [squeeze-excite] -> 1x1 project -> BN [+ input]."""

    def __init__(self, in_ch: int, spec: IRSpec, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        s = self.spec = spec
        self.act = ACTIVATIONS[s.act]
        self.residual = s.stride == 1 and in_ch == s.out_ch
        # a depthwise-separable block has no expansion: its depthwise conv is Conv_0
        self.first = 0 if s.ds else 1
        if not s.ds:
            self.Conv_0 = Conv(in_ch, s.exp_ch, (1, 1), use_bias=False, dtype=dtype)
            self.BatchNorm_0 = BatchNorm(s.exp_ch)
        dw_in = in_ch if s.ds else s.exp_ch
        i = self.first
        self.add_module(f"Conv_{i}", Conv(
            dw_in, s.exp_ch, (s.kernel, s.kernel), use_bias=False, dtype=dtype,
            strides=(s.stride, s.stride), groups=dw_in,
        ))
        self.add_module(f"BatchNorm_{i}", BatchNorm(s.exp_ch))
        if s.se:
            self.SqueezeExcite_0 = SqueezeExcite(
                s.exp_ch, make_divisible(s.exp_ch * 0.25), dtype=dtype
            )
        self.add_module(
            f"Conv_{i + 1}", Conv(s.exp_ch, s.out_ch, (1, 1), use_bias=False, dtype=dtype)
        )
        self.add_module(f"BatchNorm_{i + 1}", BatchNorm(s.out_ch))

    def _conv_bn(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if not self.spec.ds:
            h = self.act(self._conv_bn(0, h))
        h = self.act(self._conv_bn(self.first, h))
        if self.spec.se:
            h = self.SqueezeExcite_0(h)
        h = self._conv_bn(self.first + 1, h)
        return h + x if self.residual else h


class MobileNetV3Encoder(nn.Module):
    """Encoder with 5-scale pyramid taps (plus the raw input as scale 0);
    ``remat``: each inverted-residual block rematerialised."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.conv_stem = Conv(
            ENCODER_OUT_CHANNELS[0], STEM_CH, (3, 3), use_bias=False, dtype=dtype,
            strides=(2, 2),
        )
        self._stem_bn = RawBatchNorm(STEM_CH)
        ch = STEM_CH
        for i, stage in enumerate(MOBILENETV3_LARGE_SPECS):
            for j, spec in enumerate(stage):
                self.add_module(f"stages_{i}_{j}", InvertedResidual(ch, spec, dtype=dtype))
                ch = spec.out_ch
        self.conv_head = Conv(ch, CONV_HEAD_CH, (1, 1), use_bias=False, dtype=dtype)
        self._head_bn = RawBatchNorm(CONV_HEAD_CH)

    def run_stem(self, x: torch.Tensor) -> torch.Tensor:
        with at_level(1):
            return ACTIVATIONS["hardswish"](self._stem_bn(self.conv_stem(from_finer(x))))

    def run_stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        level = STAGE_IN_LEVEL[i]
        for j, spec in enumerate(MOBILENETV3_LARGE_SPECS[i]):
            block = getattr(self, f"stages_{i}_{j}")
            if spec.stride == 2:
                level += 1
            with at_level(level):
                if spec.stride == 2:
                    x = from_finer(x)
                x = checkpointed(block, x) if self.remat else block(x)
        return x

    def run_head(self, x: torch.Tensor) -> torch.Tensor:
        with at_level(NUM_LEVELS):
            return ACTIVATIONS["hardswish"](self._head_bn(self.conv_head(x)))

    def forward(self, x: torch.Tensor) -> t.List[torch.Tensor]:
        feats = [x]
        h = self.run_stem(x)
        for i in range(NUM_STAGES):
            h = self.run_stage(i, h)
            if i in FEATURE_TAP_AFTER_STAGE:
                feats.append(h)
        feats.append(self.run_head(h))
        return feats
