"""The reference repository's ``BasicMTLModel``: a segmentation_models
Unet on timm's ``mobilenetv3_large_100`` encoder (Howard et al.,
"Searching for MobileNetV3", ICCV 2019), decoder widths halving from
``decoder_first_channel``, and two 3x3 heads (segmentation logits, one
depth channel) on the decoder's last map. Plain PyTorch, float32, NHWC."""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from portbench.reference.common import (
    BatchNorm,
    Conv,
    ConvBNAct,
    F32,
    Precision,
    hard_sigmoid,
    hard_swish,
    upsample_nearest_2x,
)

# (expansion, out, kernel, stride, squeeze-excite, activation) per block,
# stage by stage: timm's mobilenetv3_large_100 at width 1.0
STAGES = (
    ((16, 16, 3, 1, False, "relu"),),
    ((64, 24, 3, 2, False, "relu"), (72, 24, 3, 1, False, "relu")),
    ((72, 40, 5, 2, True, "relu"), (120, 40, 5, 1, True, "relu"),
     (120, 40, 5, 1, True, "relu")),
    ((240, 80, 3, 2, False, "hardswish"), (200, 80, 3, 1, False, "hardswish"),
     (184, 80, 3, 1, False, "hardswish"), (184, 80, 3, 1, False, "hardswish")),
    ((480, 112, 3, 1, True, "hardswish"), (672, 112, 3, 1, True, "hardswish")),
    ((672, 160, 5, 2, True, "hardswish"), (960, 160, 5, 1, True, "hardswish"),
     (960, 160, 5, 1, True, "hardswish")),
)
ACT = {"relu": torch.relu, "hardswish": hard_swish}
#: the stages after which the encoder's pyramid is tapped (strides 2-16);
#: the stride-32 tap is the 960-channel conv head
TAPS = (0, 1, 2, 4)
HEAD_CH = 960


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, reduced: int, precision: Precision):
        super().__init__()
        self.act = precision.act
        self.Conv_0 = Conv(ch, reduced, k=1, precision=precision)
        self.Conv_1 = Conv(reduced, ch, k=1, precision=precision)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.Conv_1(torch.relu(self.Conv_0(x.mean((1, 2), keepdim=True))))
        return self.act(x * self.act(hard_sigmoid(s)))


class InvertedResidual(nn.Module):
    """[1x1 expand -> BN -> act] -> depthwise kxk (strided) -> BN -> act ->
    [squeeze-excite] -> 1x1 project -> BN [+ input]; the first stage's block
    has no expansion."""

    def __init__(self, in_ch: int, spec: tuple, first: bool, precision: Precision):
        super().__init__()
        exp, out, k, stride, se, act = spec
        self.fn, self.round, self.se = ACT[act], precision.act, se
        self.residual = stride == 1 and in_ch == out
        self.i = 0 if first else 1
        if not first:
            self.Conv_0 = Conv(in_ch, exp, k=1, bias=False, precision=precision)
            self.BatchNorm_0 = BatchNorm(exp, precision)
        dw_in = in_ch if first else exp
        self.add_module(f"Conv_{self.i}", Conv(dw_in, exp, k=k, bias=False, stride=stride,
                                               groups=dw_in, precision=precision))
        self.add_module(f"BatchNorm_{self.i}", BatchNorm(exp, precision))
        if se:
            self.SqueezeExcite_0 = SqueezeExcite(exp, make_divisible(exp * 0.25), precision)
        self.add_module(f"Conv_{self.i + 1}", Conv(exp, out, k=1, bias=False, precision=precision))
        self.add_module(f"BatchNorm_{self.i + 1}", BatchNorm(out, precision))

    def _cbn(self, j: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"BatchNorm_{j}")(getattr(self, f"Conv_{j}")(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.i == 0 else self.round(self.fn(self._cbn(0, x)))
        h = self.round(self.fn(self._cbn(self.i, h)))
        if self.se:
            h = self.SqueezeExcite_0(h)
        h = self._cbn(self.i + 1, h)
        return self.round(h + x) if self.residual else h


class Encoder(nn.Module):
    def __init__(self, precision: Precision):
        super().__init__()
        self.round = precision.act
        self.conv_stem = Conv(3, 16, k=3, bias=False, stride=2, precision=precision)
        self._stem_bn = BatchNorm(16)
        ch = 16
        for i, stage in enumerate(STAGES):
            for j, spec in enumerate(stage):
                self.add_module(f"stages_{i}_{j}",
                                InvertedResidual(ch, spec, i == 0, precision))
                ch = spec[1]
        self.conv_head = Conv(ch, HEAD_CH, k=1, bias=False, precision=precision)
        self._head_bn = BatchNorm(HEAD_CH, precision)

    def forward(self, x: torch.Tensor) -> t.List[torch.Tensor]:
        feats = []
        h = self.round(hard_swish(self._stem_bn(self.conv_stem(self.round(x)))))
        for i, stage in enumerate(STAGES):
            for j in range(len(stage)):
                h = getattr(self, f"stages_{i}_{j}")(h)
            if i in TAPS:
                feats.append(h)
        feats.append(self.round(hard_swish(self._head_bn(self.conv_head(h)))))
        return feats  # strides 2, 4, 8, 16, 32


class DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, precision: Precision):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(in_ch + skip_ch, out_ch, precision)
        self.ConvBNAct_1 = ConvBNAct(out_ch, out_ch, precision)

    def forward(self, x, skip=None):
        x = upsample_nearest_2x(x)
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        return self.ConvBNAct_1(self.ConvBNAct_0(x))


class Decoder(nn.Module):
    def __init__(self, channels: t.Sequence[int], precision: Precision):
        super().__init__()
        skips = (112, 40, 24, 16)
        in_ch = HEAD_CH
        for i, out_ch in enumerate(channels):
            skip = skips[i] if i < len(skips) else 0
            self.add_module(f"block_{i}", DecoderBlock(in_ch, skip, out_ch, precision))
            in_ch = out_ch
        self.n = len(channels)

    def forward(self, feats: t.List[torch.Tensor]) -> torch.Tensor:
        x, *skips = feats[::-1]
        for i in range(self.n):
            x = getattr(self, f"block_{i}")(x, skips[i] if i < len(skips) else None)
        return x


class Backbone(nn.Module):
    def __init__(self, decoder_first_channel: int, num_decoder_layers: int, precision: Precision):
        super().__init__()
        channels = [decoder_first_channel // 2**i for i in range(num_decoder_layers)]
        self.encoder = Encoder(precision)
        self.decoder = Decoder(channels, precision)
        self.out_ch = channels[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))


class Head(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, precision: Precision):
        super().__init__()
        self.Conv_0 = Conv(in_ch, out_ch, k=3, precision=precision)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


class Basic(nn.Module):
    def __init__(self, segm_classes: int, decoder_first_channel: int = 540,
                 num_decoder_layers: int = 5, precision: Precision = F32):
        super().__init__()
        self.backbone = Backbone(decoder_first_channel, num_decoder_layers, precision)
        self.segm_head = Head(self.backbone.out_ch, segm_classes, precision)
        self.depth_head = Head(self.backbone.out_ch, 1, precision)

    def forward(self, x: torch.Tensor) -> t.Dict[str, torch.Tensor]:
        h = self.backbone(x)
        return {"segm": self.segm_head(h), "depth": self.depth_head(h)}


def build(config: t.Mapping[str, t.Any], precision: Precision = F32) -> Basic:
    arch = config["architecture"]
    return Basic(config["num_classes"], arch["decoder_first_channel"], arch["num_decoder_layers"],
                 precision=precision)
