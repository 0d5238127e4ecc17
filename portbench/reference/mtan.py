"""MTAN on a mini-Unet (Liu et al., "End-to-End Multi-Task Learning with
Attention", CVPR 2019), as the reference repository
kirilllzaitsev/vision_mtl builds it (``MTANMiniUnet``): a shared Unet of
DoubleConvs with, per task and level, an attention stream whose gate
multiplies the shared features; 1x1 heads on the task streams. Plain
PyTorch, float32, NHWC."""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from portbench.reference.common import (
    BatchNorm,
    Conv,
    ConvTranspose,
    DoubleConv,
    GateChain,
    F32,
    Precision,
    max_pool_2x,
    pad_to,
    resize_align_corners,
)


class AttentionEncoder(nn.Module):
    """cat(level input, previous stream) -> gate on the level's DoubleConv
    output -> 3x3 conv-BN-ReLU -> 2x2 max pool."""

    def __init__(self, in_ch: int, out_ch: int, shared_ch: int, hidden: int, precision: Precision):
        super().__init__()
        self.GateChain_0 = GateChain(in_ch, hidden, shared_ch, precision)
        self.Conv_0 = Conv(shared_ch, out_ch, precision=precision)
        self.BatchNorm_0 = BatchNorm(out_ch, precision)

    def forward(self, level_in, shared, prev):
        h = level_in if prev is None else torch.cat([level_in, prev], dim=-1)
        g = self.GateChain_0(h, shared)
        return max_pool_2x(torch.relu(self.BatchNorm_0(self.Conv_0(g))))


class AttentionDecoder(nn.Module):
    """3x3 conv-BN-ReLU on the previous stream, resized (bilinear, corners
    aligned) to the skip -> cat with the merged map -> gate on the level's
    DoubleConv output -> 3x3 conv-BN-ReLU."""

    def __init__(self, merged_ch: int, prev_ch: int, shared_ch: int, out_ch: int, hidden: int,
                 precision: Precision):
        super().__init__()
        self.act = precision.act
        self.Conv_0 = Conv(prev_ch, hidden, precision=precision)
        self.BatchNorm_0 = BatchNorm(hidden, precision)
        self.GateChain_0 = GateChain(merged_ch + hidden, hidden, shared_ch, precision)
        self.Conv_1 = Conv(shared_ch, out_ch, precision=precision)
        self.BatchNorm_1 = BatchNorm(out_ch, precision)

    def forward(self, merged, prev, shared):
        p = torch.relu(self.BatchNorm_0(self.Conv_0(prev)))
        p = self.act(resize_align_corners(p, merged.shape[1], merged.shape[2]))
        g = self.GateChain_0(torch.cat([merged, p], dim=-1), shared)
        return torch.relu(self.BatchNorm_1(self.Conv_1(g)))


class MTAN(nn.Module):
    def __init__(self, tasks: t.Dict[str, int], encoder_first_channel: int = 32,
                 encoder_num_channels: int = 4, task_subnets_hidden_channels: int = 128,
                 in_channels: int = 3, precision: Precision = F32):
        super().__init__()
        self.act = precision.act
        self.tasks = list(tasks)
        self.levels = encoder_num_channels
        hidden = task_subnets_hidden_channels
        enc = [encoder_first_channel * 2**i for i in range(encoder_num_channels)]
        level_in = in_channels
        for i, ch in enumerate(enc):
            self.add_module(f"enc_dconv_{i}", DoubleConv(level_in, ch, precision))
            gate_in = level_in + (enc[i - 1] if i else 0)
            for ti in range(len(self.tasks)):
                self.add_module(f"enc_attn_{i}_task{ti}",
                                AttentionEncoder(gate_in, ch, ch, hidden, precision))
            level_in = ch
        shared_ch = enc[-1] * 2
        self.bottleneck = DoubleConv(enc[-1], shared_ch, precision)
        prev_ch = enc[-1]
        for i, ch in enumerate(enc[::-1]):
            up_ch = shared_ch // 2
            self.add_module(f"dec_up_{i}", ConvTranspose(shared_ch, up_ch, precision))
            merged_ch = ch + up_ch
            self.add_module(f"dec_dconv_{i}", DoubleConv(merged_ch, ch, precision))
            for ti in range(len(self.tasks)):
                self.add_module(f"dec_attn_{i}_task{ti}",
                                AttentionDecoder(merged_ch, prev_ch, ch, ch, hidden, precision))
            shared_ch = prev_ch = ch
        for name, n_out in tasks.items():
            self.add_module(f"head_{name}", Conv(prev_ch, n_out, k=1, precision=precision))

    def forward(self, x: torch.Tensor) -> t.Dict[str, torch.Tensor]:
        n = len(self.tasks)
        shared, streams, features = self.act(x), [None] * n, []
        for i in range(self.levels):
            out = getattr(self, f"enc_dconv_{i}")(shared)
            streams = [getattr(self, f"enc_attn_{i}_task{ti}")(shared, out, streams[ti])
                       for ti in range(n)]
            features.append(out)
            shared = max_pool_2x(out)
        shared = self.bottleneck(shared)
        for i in range(self.levels):
            skip = features[self.levels - 1 - i]
            up = pad_to(getattr(self, f"dec_up_{i}")(shared), skip.shape[1], skip.shape[2])
            merged = torch.cat([skip, up], dim=-1)
            out = getattr(self, f"dec_dconv_{i}")(merged)
            streams = [getattr(self, f"dec_attn_{i}_task{ti}")(merged, streams[ti], out)
                       for ti in range(n)]
            shared = out
        return {name: getattr(self, f"head_{name}")(streams[ti])
                for ti, name in enumerate(self.tasks)}


def build(config: t.Mapping[str, t.Any], precision: Precision = F32) -> MTAN:
    arch = config["architecture"]
    return MTAN({"depth": 1, "segm": config["num_classes"]}, arch["encoder_first_channel"],
                arch["encoder_num_channels"], arch["task_subnets_hidden_channels"],
                precision=precision)
