"""Cross-Stitch network, CSNet (counterpart of
``vision_mtl_tpu/models/cross_stitch.py``).

One MobileNetV3-Large encoder and one Unet decoder per task, joined by
stitch units at fixed points of the forward:

  * after each of the six encoder stages (widths 16, 24, 40, 80, 112, 160);
    the skip maps are taken after stages 0, 1, 2 and 4, before the stitch;
  * at the entry of each of the five decoder blocks, after the skip merge
    (widths ``dec_in + skip``: 1072, 296, 152, 80, 32 at the trained width).

Two behaviours of the reference are kept by default, as in the JAX package:
the stitch scales task t by its own weight ``W[t, t]`` only (its einsum
repeats a subscript; ``full_mix=True`` mixes the tasks), and the decoder
zero-pads the coarse map, centred, up to the skip's size instead of
upsampling it (``upsample_skips=True`` upsamples it 2x, crops it to the
skip's size and pads any deficit). The merge is ``cat([skip, h])``, the
skip first; the last block has no skip and takes a nearest 2x upsample.

A decoder block's and a head's 3x3 conv runs through kernel B3 when its
channels are under 100. At the trained width (decoder 256, 128, 64, 32, 16)
those are, per task, block 2's second conv (64 -> 64), both convs of
blocks 3 and 4 (80 -> 32, 32 -> 32, 32 -> 16, 16 -> 16) and the head
(16 -> 1 or 16 -> classes): 12 launches per forward, 12 more for their dx
in a backward.

``remat_encoder`` rematerialises every block of both encoders in the
backward pass, ``remat_tail`` the last N decoder blocks of each task's
decoder (``blocks.checkpointed``); neither changes a parameter.

Submodule names are the flax names (``encoders_{t}``, ``decoders_{t}_{d}``,
``heads_{t}``, ``enc_stitches_{i}``, ``dec_stitches_{i}``), so
``weights.load_jax_variables`` walks both trees side by side.
"""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from vision_mtl_tpu_torch.models.blocks import checkpointed, init_weights
from vision_mtl_tpu_torch.models.mobilenetv3 import (
    CONV_HEAD_CH,
    ENCODER_STRIDE,
    FEATURE_TAP_AFTER_STAGE,
    NUM_STAGES,
    STAGE_OUT_CHANNELS,
    MobileNetV3Encoder,
)
from vision_mtl_tpu_torch.models.unet_decoder import (
    DecoderBlock,
    SegmentationHead,
    decoder_channels,
)
from vision_mtl_tpu_torch.ops.interpolate import pad_concat, upsample_nearest_2x


def get_joint_layer_names(num_decoder_layers: int = 5) -> t.List[str]:
    """Names of CSNet's stitch points in forward order: one per encoder
    stage, then one per decoder block."""
    enc = [f"encoder.stage{i}" for i in range(NUM_STAGES)]
    dec = [f"decoder.block{i}" for i in range(num_decoder_layers)]
    return enc + dec


class CrossStitchLayer(nn.Module):
    """A stitch unit over the tasks' feature maps: weights (T, T), or
    (T, T, C) channel-wise, drawn uniform in [0, 1).

    By default task t's map is scaled by ``W[t, t(, c)]``; ``full_mix``
    gives ``y[a] = sum_b W[a, b(, c)] x[b]``. Computes in f32 (f64 for f64)
    and returns each map in its input's dtype."""

    def __init__(
        self, num_tasks: int, num_channels: t.Optional[int] = None, full_mix: bool = False
    ):
        super().__init__()
        self.full_mix = full_mix
        shape = (num_tasks, num_tasks) + (() if num_channels is None else (num_channels,))
        self.weights = nn.Parameter(torch.empty(shape))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weights.uniform_(0.0, 1.0, generator=generator)

    def forward(self, feats: t.Sequence[torch.Tensor]) -> t.List[torch.Tensor]:
        cd = torch.promote_types(feats[0].dtype, torch.float32)
        w = self.weights.to(cd)
        xs = [f.to(cd) for f in feats]
        if self.full_mix:
            out = []
            for a in range(len(xs)):
                y = w[a, 0] * xs[0]
                for b in range(1, len(xs)):
                    y = y + w[a, b] * xs[b]
                out.append(y)
        else:
            out = [w[i, i] * x for i, x in enumerate(xs)]
        return [y.to(f.dtype) for y, f in zip(out, feats)]


class CSNet(nn.Module):
    """Per-task MobileNetV3-Unet networks joined by stitch units. Input NHWC;
    output ``{task: (B, H, W, channels)}`` in ``dtype``, tasks in the order
    of ``task_channels``.

    Built in eval mode with fresh weights from ``seed``.
    """

    def __init__(
        self,
        task_channels: t.Dict[str, int],
        decoder_first_channel: int = 256,
        num_decoder_layers: int = 5,
        channel_wise_stitching: bool = True,
        full_mix: bool = False,
        upsample_skips: bool = False,
        remat_encoder: bool = False,
        remat_tail: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
    ):
        super().__init__()
        self.task_names = list(task_channels)
        self.num_decoder_layers = num_decoder_layers
        #: the encoders' stride at their coarsest level (``parallel/mesh.check_rows``)
        self.row_stride = ENCODER_STRIDE
        self.remat_tail = remat_tail
        self.upsample_skips = upsample_skips
        n = len(self.task_names)
        dch = decoder_channels(decoder_first_channel, num_decoder_layers)
        skip_ch = [STAGE_OUT_CHANNELS[s] for s in FEATURE_TAP_AFTER_STAGE]  # 16, 24, 40, 112
        dec_in_ch = [CONV_HEAD_CH] + dch[:-1]
        dec_stitch_ch = [
            dec_in_ch[d] + (skip_ch[-d - 1] if d < len(skip_ch) else 0)
            for d in range(num_decoder_layers)
        ]

        for ti in range(n):
            self.add_module(
                f"encoders_{ti}", MobileNetV3Encoder(dtype=dtype, remat=remat_encoder)
            )
        for ti in range(n):
            for d, out_ch in enumerate(dch):
                self.add_module(
                    f"decoders_{ti}_{d}",
                    DecoderBlock(dec_stitch_ch[d], 0, out_ch, dtype=dtype, upsample=False),
                )
        for ti, name in enumerate(self.task_names):
            self.add_module(
                f"heads_{ti}", SegmentationHead(dch[-1], task_channels[name], dtype=dtype)
            )

        def stitch(ch: int) -> CrossStitchLayer:
            return CrossStitchLayer(n, ch if channel_wise_stitching else None, full_mix)

        for i, ch in enumerate(STAGE_OUT_CHANNELS):
            self.add_module(f"enc_stitches_{i}", stitch(ch))
        for d, ch in enumerate(dec_stitch_ch):
            self.add_module(f"dec_stitches_{d}", stitch(ch))

        init_weights(self, seed)
        self.eval()

    def _merge(self, h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """``cat([skip, h])`` with h brought to the skip's H, W."""
        if self.upsample_skips:
            # a size that is not a multiple of 32 leaves the upsample a pixel
            # off the skip (the strided encoder rounds up): crop any excess,
            # pad any deficit
            h = upsample_nearest_2x(h)[:, : skip.shape[1], : skip.shape[2]]
        return pad_concat(h, skip.to(h.dtype))

    def forward(self, x: torch.Tensor) -> t.Dict[str, torch.Tensor]:
        n = len(self.task_names)
        encoders = [getattr(self, f"encoders_{ti}") for ti in range(n)]
        feats = [enc.run_stem(x) for enc in encoders]
        skips: t.List[t.List[torch.Tensor]] = [[] for _ in range(n)]
        for s in range(NUM_STAGES):
            feats = [enc.run_stage(s, f) for enc, f in zip(encoders, feats)]
            if s in FEATURE_TAP_AFTER_STAGE:
                for ti in range(n):
                    skips[ti].append(feats[ti])
            feats = getattr(self, f"enc_stitches_{s}")(feats)
        feats = [enc.run_head(f) for enc, f in zip(encoders, feats)]

        for d in range(self.num_decoder_layers):
            merged = [
                self._merge(h, skips[ti][-d - 1]) if d < len(skips[ti]) else upsample_nearest_2x(h)
                for ti, h in enumerate(feats)
            ]
            merged = getattr(self, f"dec_stitches_{d}")(merged)
            remat = d >= self.num_decoder_layers - self.remat_tail
            blocks = [getattr(self, f"decoders_{ti}_{d}") for ti in range(n)]
            feats = [checkpointed(b, m) if remat else b(m) for b, m in zip(blocks, merged)]

        return {
            name: getattr(self, f"heads_{ti}")(feats[ti])
            for ti, name in enumerate(self.task_names)
        }
