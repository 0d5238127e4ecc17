"""MTAN — Multi-Task Attention Network on a mini-Unet global net
(counterpart of ``vision_mtl_tpu/models/mtan.py``, unfolded tasks).

A shared mini-Unet "global" network with per-task attention streams beside
it. Per encoder level a task stream computes a sigmoid gate from (shared
input, previous task features) and modulates the shared DoubleConv output;
per decoder level the gate is computed from the merged skip features and
the upsampled task stream. Task heads are 1x1 convs on the final streams.

Every gate runs through a fused CUDA kernel, 16 launches per forward at the
trained config (4 encoder + 4 decoder levels, 2 tasks): in eval mode the
folded-BN gate (``kernels/fused_gate.py``), in train mode the three-pass
batch-statistic gate (``kernels/fused_gate_train.py``). ``model.train()`` and
``model.eval()`` switch every block. Submodule names are the flax names, so
``weights.load_jax_variables`` can walk both trees side by side.
"""

from __future__ import annotations

import math
import typing as t

import torch
from torch import nn

from vision_mtl_tpu_torch.kernels.fused_gate import fold_bn, fused_attention_gate
from vision_mtl_tpu_torch.kernels.fused_gate_train import fused_attention_gate_train
from vision_mtl_tpu_torch.models.blocks import (
    BatchNorm,
    Conv,
    ConvTranspose,
    DoubleConv,
    init_weights,
    max_pool_2x,
    update_running_stats,
)
from vision_mtl_tpu_torch.ops.interpolate import pad_concat, resize_bilinear_align_corners


class GateChain(nn.Module):
    """``shared * sigmoid(BN2(conv1x1(relu(BN1(conv1x1(x))))))``.

    Eval mode folds both BNs' running statistics into the 1x1 weights and
    runs the fused gate kernel. Train mode runs the three-pass kernel, which
    normalises with the batch statistics, and then updates the running
    statistics from them as the JAX GateChain does (retain 0.9, and the
    n/(n-1) correction under the torch-running-var switch).
    """

    def __init__(self, in_ch: int, hidden: int, gate_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.w1 = nn.Parameter(torch.empty(in_ch, hidden))
        self.b1 = nn.Parameter(torch.empty(hidden))
        self.w2 = nn.Parameter(torch.empty(hidden, gate_features))
        self.b2 = nn.Parameter(torch.empty(gate_features))
        self.scale1 = nn.Parameter(torch.ones(hidden))
        self.bias1 = nn.Parameter(torch.zeros(hidden))
        self.scale2 = nn.Parameter(torch.ones(gate_features))
        self.bias2 = nn.Parameter(torch.zeros(gate_features))
        self.register_buffer("mean1", torch.zeros(hidden))
        self.register_buffer("var1", torch.ones(hidden))
        self.register_buffer("mean2", torch.zeros(gate_features))
        self.register_buffer("var2", torch.ones(gate_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for w, b in ((self.w1, self.b1), (self.w2, self.b2)):
                bound = 1.0 / math.sqrt(w.shape[0])
                w.uniform_(-bound, bound, generator=generator)
                b.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, shared: torch.Tensor) -> torch.Tensor:
        x = x.to(shared.dtype).contiguous()
        shared = shared.contiguous()
        if self.training:
            out, mean1, var1, mean2, var2 = fused_attention_gate_train(
                x, shared, self.w1, self.b1, self.scale1, self.bias1,
                self.w2, self.b2, self.scale2, self.bias2, self.eps,
            )
            n = x.numel() // x.shape[-1]
            update_running_stats(self.mean1, self.var1, mean1, var1, n)
            update_running_stats(self.mean2, self.var2, mean2, var2, n)
            return out
        s1, c1 = fold_bn(self.b1, self.scale1, self.bias1, self.mean1, self.var1, self.eps)
        s2, c2 = fold_bn(self.b2, self.scale2, self.bias2, self.mean2, self.var2, self.eps)
        return fused_attention_gate(x, shared, self.w1 * s1, c1, self.w2 * s2, c2)


class AttentionModuleEncoder(nn.Module):
    """concat(shared1, prev) -> gate * shared2 -> 3x3 conv-BN-ReLU -> maxpool."""

    def __init__(
        self,
        in_ch: int,
        out_channels: int,
        shared_2_channels: int,
        hidden_channels: int = 64,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.GateChain_0 = GateChain(in_ch, hidden_channels, shared_2_channels)
        self.Conv_0 = Conv(shared_2_channels, out_channels, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(out_channels)

    def forward(
        self,
        conv1_shared: torch.Tensor,
        conv2_shared: torch.Tensor,
        prev_layer_outs: t.Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if prev_layer_outs is None:
            h = conv1_shared
        else:
            h = torch.cat([conv1_shared, prev_layer_outs.to(conv1_shared.dtype)], dim=-1)
        g = self.GateChain_0(h, conv2_shared)
        g = torch.relu(self.BatchNorm_0(self.Conv_0(g)))
        return max_pool_2x(g)


class AttentionModuleDecoder(nn.Module):
    """3x3 conv on the previous task stream (+ bilinear align_corners resize
    to the skip's size) -> concat with shared1 -> gate * shared2 -> 3x3
    conv-BN-ReLU."""

    def __init__(
        self,
        merged_ch: int,
        prev_ch: int,
        shared_2_channels: int,
        out_channels: int,
        hidden_channels: int = 64,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.Conv_0 = Conv(prev_ch, hidden_channels, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(hidden_channels)
        self.GateChain_0 = GateChain(
            merged_ch + hidden_channels, hidden_channels, shared_2_channels
        )
        self.Conv_1 = Conv(shared_2_channels, out_channels, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(out_channels)

    def forward(
        self,
        conv1_shared: torch.Tensor,
        prev_layer_outs: torch.Tensor,
        conv2_shared: torch.Tensor,
    ) -> torch.Tensor:
        p = torch.relu(self.BatchNorm_0(self.Conv_0(prev_layer_outs)))
        p = resize_bilinear_align_corners(p, conv1_shared.shape[1], conv1_shared.shape[2])
        merged = torch.cat([conv1_shared, p.to(conv1_shared.dtype)], dim=-1)
        g = self.GateChain_0(merged, conv2_shared)
        return torch.relu(self.BatchNorm_1(self.Conv_1(g)))


class MTANMiniUnet(nn.Module):
    """Mini-Unet global net + per-task attention streams. Input NHWC; output
    ``{task: (B, H, W, channels)}`` in ``dtype``.

    Built in eval mode with fresh weights from ``seed``.
    """

    def __init__(
        self,
        map_tasks_to_num_channels: t.Dict[str, int],
        task_subnets_hidden_channels: int = 128,
        encoder_first_channel: int = 64,
        encoder_num_channels: int = 4,
        in_channels: int = 3,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
    ):
        super().__init__()
        self.task_names = list(map_tasks_to_num_channels)
        self.num_levels = encoder_num_channels
        hidden = task_subnets_hidden_channels
        enc_out = [encoder_first_channel * 2**i for i in range(encoder_num_channels)]
        dec_out = enc_out[::-1]

        level_in = in_channels
        for i, ch in enumerate(enc_out):
            self.add_module(f"enc_dconv_{i}", DoubleConv(level_in, ch, dtype=dtype))
            gate_in = level_in + (enc_out[i - 1] if i else 0)
            for ti in range(len(self.task_names)):
                self.add_module(
                    f"enc_attn_{i}_task{ti}",
                    AttentionModuleEncoder(gate_in, ch, ch, hidden, dtype=dtype),
                )
            level_in = ch

        shared_ch = enc_out[-1] * 2
        self.bottleneck = DoubleConv(enc_out[-1], shared_ch, dtype=dtype)

        prev_ch = enc_out[-1]
        for i, ch in enumerate(dec_out):
            up_ch = shared_ch // 2
            self.add_module(f"dec_up_{i}", ConvTranspose(shared_ch, up_ch, dtype=dtype))
            merged_ch = ch + up_ch  # the skip has enc_out[-(i+1)] == ch channels
            self.add_module(f"dec_dconv_{i}", DoubleConv(merged_ch, ch, dtype=dtype))
            for ti in range(len(self.task_names)):
                self.add_module(
                    f"dec_attn_{i}_task{ti}",
                    AttentionModuleDecoder(merged_ch, prev_ch, ch, ch, hidden, dtype=dtype),
                )
            shared_ch = prev_ch = ch

        for name, n_out in map_tasks_to_num_channels.items():
            self.add_module(f"head_{name}", Conv(prev_ch, n_out, (1, 1), dtype=dtype))

        init_weights(self, seed)
        self.eval()

    def forward(self, x: torch.Tensor) -> t.Dict[str, torch.Tensor]:
        n_tasks = len(self.task_names)
        shared = x
        streams: t.List[t.Optional[torch.Tensor]] = [None] * n_tasks
        features = []
        for i in range(self.num_levels):
            level_in = shared
            dconv_out = getattr(self, f"enc_dconv_{i}")(level_in)
            streams = [
                getattr(self, f"enc_attn_{i}_task{ti}")(level_in, dconv_out, streams[ti])
                for ti in range(n_tasks)
            ]
            features.append(dconv_out)
            shared = max_pool_2x(dconv_out)

        shared = self.bottleneck(shared)

        for i in range(self.num_levels):
            up = getattr(self, f"dec_up_{i}")(shared)
            skip = features[-(i + 1)]
            merged = pad_concat(up, skip.to(up.dtype))
            conv_out = getattr(self, f"dec_dconv_{i}")(merged)
            streams = [
                getattr(self, f"dec_attn_{i}_task{ti}")(merged, streams[ti], conv_out)
                for ti in range(n_tasks)
            ]
            shared = conv_out

        return {
            name: getattr(self, f"head_{name}")(streams[ti])
            for ti, name in enumerate(self.task_names)
        }
