"""Unet decoder and segmentation head, NHWC (counterpart of
``vision_mtl_tpu/models/unet_decoder.py``).

Per block: nearest x2 upsample, concat the encoder skip (if any), then two
3x3 conv-BN-ReLU. Decoder widths halve from ``decoder_first_channel``. A
block's or a head's 3x3 conv runs through kernel B3 (``ops.small_conv``)
when its input and output channels are both under 100; at the trained width
(540, 270, 135, 67, 33) those are block_3's second conv (67 -> 67) and both
of block_4's (67 -> 33, 33 -> 33); block_3's first takes 135 + 16 channels
and stays PyTorch's conv.

``fold_tail`` runs the last block, when it is skip-less, in space-to-depth
folded layout (``ops/fold.py``) and returns a FOLDED map: its convs then
have 4C channels, which B3 does not take, and are plain convolutions.
``remat_tail`` rematerialises the last N blocks in the backward pass
(``blocks.checkpointed``). Neither changes a parameter.

Under the mesh's ``spatial`` axis block i runs at level ``4 - i`` (its
skip's; ``parallel.halo.at_level``), its upsample made on the whole map
and cut to the rank's rows where the level below ran whole
(``halo.from_coarser``). A folded block's maps have the rows of the level
above (``tile_for_upsample``), so it runs at that level.
"""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from vision_mtl_tpu_torch.models.blocks import (
    Conv,
    ConvBNAct,
    FoldedConv,
    FoldedConvBNAct,
    checkpointed,
)
from vision_mtl_tpu_torch.models.mobilenetv3 import ENCODER_OUT_CHANNELS
from vision_mtl_tpu_torch.ops.fold import tile_for_upsample
from vision_mtl_tpu_torch.ops.interpolate import upsample_nearest_2x
from vision_mtl_tpu_torch.parallel.halo import at_level, coarser_level, from_coarser


def decoder_channels(decoder_first_channel: int = 256, num_decoder_layers: int = 5) -> t.List[int]:
    return [decoder_first_channel // (2**i) for i in range(num_decoder_layers)]


class DecoderBlock(nn.Module):
    """[nearest x2 upsample] -> [concat the skip] -> two 3x3 conv-BN-ReLU.
    ``upsample=False`` leaves out the upsample: CSNet merges and stitches
    its inputs itself and calls its blocks with no skip.

    ``fold=True`` (a skip-less block) takes the UNFOLDED half-resolution
    input, folds it through the upsample's channel tile, runs both convs in
    folded layout and returns a FOLDED output; the same parameters."""

    def __init__(
        self,
        in_ch: int,
        skip_ch: int,
        out_ch: int,
        dtype: torch.dtype = torch.bfloat16,
        upsample: bool = True,
        fold: bool = False,
    ):
        super().__init__()
        self.upsample = upsample
        self.fold = fold
        if fold:
            assert upsample and skip_ch == 0, "fold supports the tail block"
            self.ConvBNAct_0 = FoldedConvBNAct(in_ch, out_ch, dtype=dtype)
            self.ConvBNAct_1 = FoldedConvBNAct(out_ch, out_ch, dtype=dtype)
            return
        self.ConvBNAct_0 = ConvBNAct(in_ch + skip_ch, out_ch, dtype=dtype, small_conv=True)
        self.ConvBNAct_1 = ConvBNAct(out_ch, out_ch, dtype=dtype, small_conv=True)

    def forward(self, x: torch.Tensor, skip: t.Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.fold:
            with coarser_level():
                return self.ConvBNAct_1(self.ConvBNAct_0(tile_for_upsample(x)))
        if self.upsample:
            x = from_coarser(x, None if skip is None else skip.shape[1],
                             lambda v, _: upsample_nearest_2x(v))
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        return self.ConvBNAct_1(self.ConvBNAct_0(x))


class UnetDecoder(nn.Module):
    """Consumes the MobileNetV3 encoder's pyramid ``[x, f2, f4, f8, f16,
    f32]`` and returns a full-resolution map with ``channels[-1]``
    channels; FOLDED (B, H/2, W/2, 4 channels[-1]) with ``fold_tail`` when
    the last block is skip-less. ``remat_tail``: the last N blocks are
    rematerialised in the backward pass."""

    def __init__(
        self,
        channels: t.Sequence[int],
        fold_tail: bool = False,
        remat_tail: int = 0,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        # the stride-1 input is dropped and the rest reversed, as smp does
        head_ch, *skip_chs = list(ENCODER_OUT_CHANNELS[1:])[::-1]
        in_ch = head_ch
        for i, out_ch in enumerate(channels):
            skip_ch = skip_chs[i] if i < len(skip_chs) else 0
            fold = fold_tail and i == len(channels) - 1 and skip_ch == 0
            self.add_module(
                f"block_{i}", DecoderBlock(in_ch, skip_ch, out_ch, dtype=dtype, fold=fold)
            )
            in_ch = out_ch
        self.num_blocks = len(channels)
        self.remat_tail = remat_tail

    def forward(self, features: t.Sequence[torch.Tensor]) -> torch.Tensor:
        x, *skips = list(features[1:])[::-1]
        for i in range(self.num_blocks):
            block = getattr(self, f"block_{i}")
            skip = skips[i] if i < len(skips) else None
            with at_level(len(features) - 2 - i):
                if i >= self.num_blocks - self.remat_tail:
                    x = checkpointed(block, x, skip)
                else:
                    x = block(x, skip)
        return x


class SegmentationHead(nn.Module):
    """A 3x3 conv with bias; ``folded``: on a folded map, giving folded
    logits, with the same parameters."""

    def __init__(
        self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.bfloat16, folded: bool = False
    ):
        super().__init__()
        if folded:
            self.Conv_0 = FoldedConv(in_ch, out_ch, (3, 3), dtype=dtype)
        else:
            self.Conv_0 = Conv(in_ch, out_ch, (3, 3), dtype=dtype, small_conv=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)
