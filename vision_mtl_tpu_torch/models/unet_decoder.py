"""Unet decoder and segmentation head, NHWC (counterpart of
``vision_mtl_tpu/models/unet_decoder.py``, unfolded and without remat).

Per block: nearest x2 upsample, concat the encoder skip (if any), then two
3x3 conv-BN-ReLU. Decoder widths halve from ``decoder_first_channel``. A
block's or a head's 3x3 conv runs through kernel B3 (``ops.small_conv``)
when its input and output channels are both under 100; at the trained width
(540, 270, 135, 67, 33) those are block_3's second conv (67 -> 67) and both
of block_4's (67 -> 33, 33 -> 33); block_3's first takes 135 + 16 channels
and stays PyTorch's conv.
"""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from vision_mtl_tpu_torch.models.blocks import Conv, ConvBNAct
from vision_mtl_tpu_torch.models.mobilenetv3 import ENCODER_OUT_CHANNELS
from vision_mtl_tpu_torch.ops.interpolate import upsample_nearest_2x


def decoder_channels(decoder_first_channel: int = 256, num_decoder_layers: int = 5) -> t.List[int]:
    return [decoder_first_channel // (2**i) for i in range(num_decoder_layers)]


class DecoderBlock(nn.Module):
    """[nearest x2 upsample] -> [concat the skip] -> two 3x3 conv-BN-ReLU.
    ``upsample=False`` leaves out the upsample: CSNet merges and stitches
    its inputs itself and calls its blocks with no skip."""

    def __init__(
        self,
        in_ch: int,
        skip_ch: int,
        out_ch: int,
        dtype: torch.dtype = torch.bfloat16,
        upsample: bool = True,
    ):
        super().__init__()
        self.upsample = upsample
        self.ConvBNAct_0 = ConvBNAct(in_ch + skip_ch, out_ch, dtype=dtype, small_conv=True)
        self.ConvBNAct_1 = ConvBNAct(out_ch, out_ch, dtype=dtype, small_conv=True)

    def forward(self, x: torch.Tensor, skip: t.Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.upsample:
            x = upsample_nearest_2x(x)
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        return self.ConvBNAct_1(self.ConvBNAct_0(x))


class UnetDecoder(nn.Module):
    """Consumes the MobileNetV3 encoder's pyramid ``[x, f2, f4, f8, f16,
    f32]`` and returns a full-resolution map with ``channels[-1]``
    channels."""

    def __init__(self, channels: t.Sequence[int], dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        # the stride-1 input is dropped and the rest reversed, as smp does
        head_ch, *skip_chs = list(ENCODER_OUT_CHANNELS[1:])[::-1]
        in_ch = head_ch
        for i, out_ch in enumerate(channels):
            skip_ch = skip_chs[i] if i < len(skip_chs) else 0
            self.add_module(f"block_{i}", DecoderBlock(in_ch, skip_ch, out_ch, dtype=dtype))
            in_ch = out_ch
        self.num_blocks = len(channels)

    def forward(self, features: t.Sequence[torch.Tensor]) -> torch.Tensor:
        x, *skips = list(features[1:])[::-1]
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, skips[i] if i < len(skips) else None)
        return x


class SegmentationHead(nn.Module):
    """A 3x3 conv with bias."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(in_ch, out_ch, (3, 3), dtype=dtype, small_conv=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)
