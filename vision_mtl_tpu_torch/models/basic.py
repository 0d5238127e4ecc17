"""Hard-parameter-sharing MTL model, "basic" (counterpart of
``vision_mtl_tpu/models/basic.py``).

One MobileNetV3-Large + Unet backbone shared by two 3x3-conv task heads
(segmentation logits, 1-channel depth logits). Outputs NHWC in the compute
dtype: ``{"segm": (B, H, W, classes), "depth": (B, H, W, 1)}``.

With ``merge_heads`` (the default) both heads run as one conv on their
concatenated kernels and biases, through kernel B3 when it takes the
channels (33 -> 20 at the trained width); the parameters stay at the heads'
own paths. At the trained width a forward launches B3 four times (three
decoder convs and the merged head), a backward four more (their dx).

Options (none changes a parameter): ``fold_tail`` runs the last decoder
block and the heads in space-to-depth folded layout (``ops/fold.py``; only
with more than 4 decoder layers, where the last block is skip-less), the
heads unmerged, each unfolded by ``depth_to_space``; their convs are plain
convolutions on 4C channels, so a forward launches B3 once (block 3's 67 ->
67). ``remat_tail`` rematerialises the last N decoder blocks and
``remat_encoder`` every encoder block in the backward pass.
"""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from vision_mtl_tpu_torch.kernels.small_conv import fits as small_conv_fits
from vision_mtl_tpu_torch.models.blocks import conv_nhwc, init_weights
from vision_mtl_tpu_torch.models.mobilenetv3 import ENCODER_STRIDE, MobileNetV3Encoder
from vision_mtl_tpu_torch.ops.fold import depth_to_space
from vision_mtl_tpu_torch.models.unet_decoder import (
    SegmentationHead,
    UnetDecoder,
    decoder_channels,
)


class Backbone(nn.Module):
    """Encoder + Unet decoder."""

    def __init__(
        self,
        decoder_first_channel: int = 256,
        num_decoder_layers: int = 5,
        fold_tail: bool = False,
        remat_tail: int = 0,
        remat_encoder: bool = False,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.decoder_channels = decoder_channels(decoder_first_channel, num_decoder_layers)
        self.encoder = MobileNetV3Encoder(dtype=dtype, remat=remat_encoder)
        self.decoder = UnetDecoder(
            self.decoder_channels, fold_tail=fold_tail, remat_tail=remat_tail, dtype=dtype
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))


class BasicMTLModel(nn.Module):
    """Built in eval mode with fresh weights from ``seed``."""

    def __init__(
        self,
        segm_classes: int,
        decoder_first_channel: int = 256,
        num_decoder_layers: int = 5,
        fold_tail: bool = False,
        remat_tail: int = 0,
        remat_encoder: bool = False,
        merge_heads: bool = True,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
    ):
        super().__init__()
        self.dtype = dtype
        self.segm_classes = segm_classes
        #: the encoder's stride at its coarsest level (see ``parallel/mesh.check_rows``)
        self.row_stride = ENCODER_STRIDE
        # the decoder folds its last block only when it is skip-less (4
        # encoder skips): the heads' layout follows the map they take
        self.fold_tail = fold_tail and num_decoder_layers > 4
        self.merge_heads = merge_heads and not self.fold_tail
        self.backbone = Backbone(
            decoder_first_channel, num_decoder_layers, fold_tail=self.fold_tail,
            remat_tail=remat_tail, remat_encoder=remat_encoder, dtype=dtype,
        )
        out_ch = self.backbone.decoder_channels[-1]
        self.segm_head = SegmentationHead(out_ch, segm_classes, dtype=dtype, folded=self.fold_tail)
        self.depth_head = SegmentationHead(out_ch, 1, dtype=dtype, folded=self.fold_tail)
        #: the merged head's conv runs through kernel B3
        self.merged_head_small_conv = small_conv_fits(out_ch, segm_classes + 1)
        init_weights(self, seed)
        self.eval()

    def heads(self, x: torch.Tensor) -> t.Dict[str, torch.Tensor]:
        if self.fold_tail:
            return {"segm": depth_to_space(self.segm_head(x)),
                    "depth": depth_to_space(self.depth_head(x))}
        if not self.merge_heads:
            return {"segm": self.segm_head(x), "depth": self.depth_head(x)}
        s, d = self.segm_head.Conv_0, self.depth_head.Conv_0
        merged = conv_nhwc(
            x, torch.cat([s.weight, d.weight]), torch.cat([s.bias, d.bias]), self.dtype,
            small_conv=self.merged_head_small_conv,
        )
        return {"segm": merged[..., : self.segm_classes], "depth": merged[..., self.segm_classes :]}

    def forward(self, x: torch.Tensor) -> t.Dict[str, torch.Tensor]:
        return self.heads(self.backbone(x))
