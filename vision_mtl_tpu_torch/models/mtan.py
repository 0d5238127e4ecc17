"""MTAN — Multi-Task Attention Network on a mini-Unet global net
(counterpart of ``vision_mtl_tpu/models/mtan.py``).

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

Options. ``remat_attention`` rematerialises the attention modules and
``remat_shared`` the shared DoubleConvs in the backward pass
(``blocks.checkpointed``; the recompute relaunches the train gate).
``fold_tasks`` runs each level's T attention modules as one module over a
leading task axis, as the JAX package's ``nn.vmap`` does: its parameters
and statistics are stacked on that axis under ``enc_attn_{i}_folded`` /
``dec_attn_{i}_folded`` with flax's leaf names, each level's gate is one
task-axis launch (8 per forward instead of 16); the 3x3 convs and BNs
run task by task (:func:`task_conv_bn_relu`). :func:`fold_task_state_dict`
converts an unfolded model's weights; a folded model drawn from a seed has
exactly the converted weights of the unfolded one from that seed.
"""

from __future__ import annotations

import math
import re
import typing as t

import torch
from torch import nn

from vision_mtl_tpu_torch.kernels.fused_gate import (
    fold_bn,
    fused_attention_gate,
    fused_attention_gate_tasks,
)
from vision_mtl_tpu_torch.kernels.fused_gate_train import (
    fused_attention_gate_train,
    fused_attention_gate_train_tasks,
)
from vision_mtl_tpu_torch.models.blocks import (
    BatchNorm,
    Conv,
    ConvTranspose,
    DoubleConv,
    _uniform_,
    batch_norm_nhwc,
    checkpointed,
    conv_nhwc,
    init_weights,
    max_pool_2x,
    update_running_stats,
)
from vision_mtl_tpu_torch.ops.interpolate import pad_concat, resize_bilinear_align_corners
from vision_mtl_tpu_torch.parallel.multihost import batch_comm


class GateChain(nn.Module):
    """``shared * sigmoid(BN2(conv1x1(relu(BN1(conv1x1(x))))))``.

    Eval mode folds both BNs' running statistics into the 1x1 weights and
    runs the fused gate kernel. Train mode runs the three-pass kernel, which
    normalises with the batch statistics, and then updates the running
    statistics from them as the JAX GateChain does (retain 0.9, and the
    n/(n-1) correction under the torch-running-var switch). Inside
    ``parallel.multihost.global_batch`` the statistics, their n included,
    are those of every rank's rows (the kernel's staged call).
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
            comm = batch_comm()
            out, mean1, var1, mean2, var2 = fused_attention_gate_train(
                x, shared, self.w1, self.b1, self.scale1, self.bias1,
                self.w2, self.b2, self.scale2, self.bias2, self.eps, comm=comm,
            )
            n = x.numel() // x.shape[-1] * (comm.world if comm is not None else 1)
            update_running_stats(self.mean1, self.var1, mean1, var1, n)
            update_running_stats(self.mean2, self.var2, mean2, var2, n)
            return out
        s1, c1 = fold_bn(self.b1, self.scale1, self.bias1, self.mean1, self.var1, self.eps)
        s2, c2 = fold_bn(self.b2, self.scale2, self.bias2, self.mean2, self.var2, self.eps)
        return fused_attention_gate(x, shared, self.w1 * s1, c1, self.w2 * s2, c2)


def _stack_tasks(module: nn.Module, one_task: nn.Module, n_tasks: int) -> None:
    """Gives ``module`` each parameter and buffer of ``one_task``, a block of
    one task built for its shapes and initial values, at the same name and
    repeated on a leading task axis."""
    for name, p in one_task.named_parameters(recurse=False):
        module.register_parameter(
            name, nn.Parameter(p.detach().expand(n_tasks, *p.shape).clone())
        )
    for name, b in one_task.named_buffers(recurse=False):
        module.register_buffer(name, b.expand(n_tasks, *b.shape).clone())


class TaskGateChain(nn.Module):
    """:class:`GateChain` of T tasks, each parameter and statistic with a
    leading task axis; x is (T, B, H, W, Cin), shared (B, H, W, C2) every
    task's. One task-axis launch of the eval gate (B1) or of the train gate
    (B4) for all tasks."""

    def __init__(
        self, n_tasks: int, in_ch: int, hidden: int, gate_features: int, eps: float = 1e-5
    ):
        super().__init__()
        self.eps = eps
        _stack_tasks(self, GateChain(in_ch, hidden, gate_features, eps), n_tasks)

    def reset_task(self, task: int, generator: torch.Generator) -> None:
        with torch.no_grad():
            for w, b in ((self.w1, self.b1), (self.w2, self.b2)):
                bound = 1.0 / math.sqrt(w.shape[1])
                w[task].uniform_(-bound, bound, generator=generator)
                b[task].uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, shared: torch.Tensor) -> torch.Tensor:
        x = x.to(shared.dtype).contiguous()
        shared = shared.contiguous()
        if self.training:
            comm = batch_comm()
            out, mean1, var1, mean2, var2 = fused_attention_gate_train_tasks(
                x, shared, self.w1, self.b1, self.scale1, self.bias1,
                self.w2, self.b2, self.scale2, self.bias2, self.eps, comm=comm,
            )
            n = x[0].numel() // x.shape[-1] * (comm.world if comm is not None else 1)
            update_running_stats(self.mean1, self.var1, mean1, var1, n)
            update_running_stats(self.mean2, self.var2, mean2, var2, n)
            return out
        s1, c1 = fold_bn(self.b1, self.scale1, self.bias1, self.mean1, self.var1, self.eps)
        s2, c2 = fold_bn(self.b2, self.scale2, self.bias2, self.mean2, self.var2, self.eps)
        return fused_attention_gate_tasks(
            x, shared, self.w1 * s1[:, None, :], c1, self.w2 * s2[:, None, :], c2
        )


class TaskConv(nn.Module):
    """The 3x3 :class:`Conv` of T tasks: weight (T, O, C, 3, 3), bias (T,
    O). Runs in :func:`task_conv_bn_relu`."""

    def __init__(
        self, n_tasks: int, in_ch: int, features: int, dtype: torch.dtype = torch.bfloat16
    ):
        super().__init__()
        self.dtype = dtype
        _stack_tasks(self, Conv(in_ch, features, (3, 3), dtype=dtype), n_tasks)

    def reset_task(self, task: int, generator: torch.Generator) -> None:
        fan_in = self.weight[task, 0].numel()
        _uniform_(self.weight[task], fan_in, generator)
        _uniform_(self.bias[task], fan_in, generator)


class TaskBatchNorm(nn.Module):
    """The :class:`BatchNorm` of T tasks: parameters and statistics (T, C).
    Runs in :func:`task_conv_bn_relu`."""

    def __init__(self, n_tasks: int, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        _stack_tasks(self, BatchNorm(features, eps), n_tasks)


def task_conv_bn_relu(conv: TaskConv, bn: TaskBatchNorm, x: torch.Tensor) -> torch.Tensor:
    """relu(bn(conv(x))) of each task on x (T, B, H, W, C) -> (T, B, H, W,
    O): a conv and a BN per task, the unfolded blocks' calls on the task's
    slice and tensors (a train-mode BN updates its task's statistics in
    place). On an H100 this took less device time than one grouped conv and
    one BN over the tasks' channels, which launch fewer kernels (PERF.md
    §6; ``chip_smoke.py`` times both ways)."""
    return torch.stack([
        torch.relu(batch_norm_nhwc(
            conv_nhwc(x[i], conv.weight[i], conv.bias[i], conv.dtype), bn.weight[i], bn.bias[i],
            bn.running_mean[i], bn.running_var[i], bn.eps, bn.training,
        ))
        for i in range(x.shape[0])
    ])


def _reset_tasks(module: nn.Module, generator: torch.Generator) -> None:
    # task by task, each child in order: the draws of the unfolded modules
    # enc/dec_attn_{i}_task0, _task1, ... from the same generator
    for i in range(module.n_tasks):
        for child in module.children():
            if hasattr(child, "reset_task"):
                child.reset_task(i, generator)


def _fold_batch(x: torch.Tensor) -> torch.Tensor:
    """(T, B, ...) -> (T B, ...)"""
    return x.reshape(-1, *x.shape[2:])


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


class TaskAttentionModuleEncoder(nn.Module):
    """:class:`AttentionModuleEncoder` of T tasks as one module (JAX's
    ``enc_attn_{i}_folded``): the previous streams (T, B, H, W, C) or None,
    the shared maps as they are; returns the new streams (T, B, H/2, W/2,
    out)."""

    def __init__(
        self,
        n_tasks: int,
        in_ch: int,
        out_channels: int,
        shared_2_channels: int,
        hidden_channels: int = 64,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.n_tasks = n_tasks
        self.GateChain_0 = TaskGateChain(n_tasks, in_ch, hidden_channels, shared_2_channels)
        self.Conv_0 = TaskConv(n_tasks, shared_2_channels, out_channels, dtype=dtype)
        self.BatchNorm_0 = TaskBatchNorm(n_tasks, out_channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_tasks(self, generator)

    def forward(
        self,
        conv1_shared: torch.Tensor,
        conv2_shared: torch.Tensor,
        prev_layer_outs: t.Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        h = conv1_shared.expand(self.n_tasks, *conv1_shared.shape)
        if prev_layer_outs is not None:
            h = torch.cat([h, prev_layer_outs.to(conv1_shared.dtype)], dim=-1)
        g = self.GateChain_0(h, conv2_shared)
        g = max_pool_2x(_fold_batch(task_conv_bn_relu(self.Conv_0, self.BatchNorm_0, g)))
        return g.reshape(self.n_tasks, -1, *g.shape[1:])


class TaskAttentionModuleDecoder(nn.Module):
    """:class:`AttentionModuleDecoder` of T tasks as one module (JAX's
    ``dec_attn_{i}_folded``): the previous streams (T, B, h, w, C), the
    shared maps as they are; returns (T, B, H, W, out)."""

    def __init__(
        self,
        n_tasks: int,
        merged_ch: int,
        prev_ch: int,
        shared_2_channels: int,
        out_channels: int,
        hidden_channels: int = 64,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.n_tasks = n_tasks
        self.Conv_0 = TaskConv(n_tasks, prev_ch, hidden_channels, dtype=dtype)
        self.BatchNorm_0 = TaskBatchNorm(n_tasks, hidden_channels)
        self.GateChain_0 = TaskGateChain(
            n_tasks, merged_ch + hidden_channels, hidden_channels, shared_2_channels
        )
        self.Conv_1 = TaskConv(n_tasks, shared_2_channels, out_channels, dtype=dtype)
        self.BatchNorm_1 = TaskBatchNorm(n_tasks, out_channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_tasks(self, generator)

    def forward(
        self,
        conv1_shared: torch.Tensor,
        prev_layer_outs: torch.Tensor,
        conv2_shared: torch.Tensor,
    ) -> torch.Tensor:
        p = _fold_batch(task_conv_bn_relu(self.Conv_0, self.BatchNorm_0, prev_layer_outs))
        p = resize_bilinear_align_corners(p, conv1_shared.shape[1], conv1_shared.shape[2])
        merged = torch.cat([
            conv1_shared.expand(self.n_tasks, *conv1_shared.shape),
            p.reshape(self.n_tasks, -1, *p.shape[1:]).to(conv1_shared.dtype),
        ], dim=-1)
        g = self.GateChain_0(merged, conv2_shared)
        return task_conv_bn_relu(self.Conv_1, self.BatchNorm_1, g)


def levels_row_stride(num_levels: int) -> int:
    """The row stride of MTAN's coarsest level: each of its ``num_levels``
    encoder levels halves the rows."""
    return 2**num_levels


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
        remat_attention: bool = False,
        remat_shared: bool = False,
        fold_tasks: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
    ):
        super().__init__()
        self.task_names = list(map_tasks_to_num_channels)
        self.num_levels = encoder_num_channels
        #: the factor by which the coarsest level's rows are fewer (the
        #: ``spatial`` axis needs H to divide by it times its size)
        self.row_stride = levels_row_stride(encoder_num_channels)
        self.remat_attention = remat_attention
        self.remat_shared = remat_shared
        self.fold_tasks = fold_tasks
        n_tasks = len(self.task_names)
        hidden = task_subnets_hidden_channels
        enc_out = [encoder_first_channel * 2**i for i in range(encoder_num_channels)]
        dec_out = enc_out[::-1]

        level_in = in_channels
        for i, ch in enumerate(enc_out):
            self.add_module(f"enc_dconv_{i}", DoubleConv(level_in, ch, dtype=dtype))
            gate_in = level_in + (enc_out[i - 1] if i else 0)
            if fold_tasks:
                self.add_module(
                    f"enc_attn_{i}_folded",
                    TaskAttentionModuleEncoder(n_tasks, gate_in, ch, ch, hidden, dtype=dtype),
                )
            for ti in range(0 if fold_tasks else n_tasks):
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
            if fold_tasks:
                self.add_module(
                    f"dec_attn_{i}_folded",
                    TaskAttentionModuleDecoder(
                        n_tasks, merged_ch, prev_ch, ch, ch, hidden, dtype=dtype
                    ),
                )
            for ti in range(0 if fold_tasks else n_tasks):
                self.add_module(
                    f"dec_attn_{i}_task{ti}",
                    AttentionModuleDecoder(merged_ch, prev_ch, ch, ch, hidden, dtype=dtype),
                )
            shared_ch = prev_ch = ch

        for name, n_out in map_tasks_to_num_channels.items():
            self.add_module(f"head_{name}", Conv(prev_ch, n_out, (1, 1), dtype=dtype))

        init_weights(self, seed)
        self.eval()

    def _shared(self, name: str, x: torch.Tensor) -> torch.Tensor:
        module = getattr(self, name)
        return checkpointed(module, x) if self.remat_shared else module(x)

    def _attention(self, name: str, *args: t.Optional[torch.Tensor]) -> torch.Tensor:
        module = getattr(self, name)
        return checkpointed(module, *args) if self.remat_attention else module(*args)

    def forward(self, x: torch.Tensor) -> t.Dict[str, torch.Tensor]:
        n_tasks = len(self.task_names)
        shared = x
        # per task, or with fold_tasks one (T, B, H, W, C) tensor
        streams: t.Any = [None] * n_tasks
        features = []
        for i in range(self.num_levels):
            level_in = shared
            dconv_out = self._shared(f"enc_dconv_{i}", level_in)
            if self.fold_tasks:
                streams = self._attention(
                    f"enc_attn_{i}_folded", level_in, dconv_out, streams if i else None
                )
            else:
                streams = [
                    self._attention(f"enc_attn_{i}_task{ti}", level_in, dconv_out, streams[ti])
                    for ti in range(n_tasks)
                ]
            features.append(dconv_out)
            shared = max_pool_2x(dconv_out)

        shared = self._shared("bottleneck", shared)

        for i in range(self.num_levels):
            up = getattr(self, f"dec_up_{i}")(shared)
            skip = features[-(i + 1)]
            merged = pad_concat(up, skip.to(up.dtype))
            conv_out = self._shared(f"dec_dconv_{i}", merged)
            if self.fold_tasks:
                streams = self._attention(f"dec_attn_{i}_folded", merged, streams, conv_out)
            else:
                streams = [
                    self._attention(f"dec_attn_{i}_task{ti}", merged, streams[ti], conv_out)
                    for ti in range(n_tasks)
                ]
            shared = conv_out

        return {
            name: getattr(self, f"head_{name}")(streams[ti])
            for ti, name in enumerate(self.task_names)
        }


def fold_task_state_dict(
    state_dict: t.Mapping[str, torch.Tensor], n_tasks: int
) -> t.Dict[str, torch.Tensor]:
    """An unfolded MTAN's state_dict (per-task ``*_task{ti}`` modules) in
    the ``fold_tasks`` layout (``*_folded`` modules, each tensor stacked on a
    leading task axis): the counterpart of the JAX package's
    ``fold_task_variables``. Exact: the folded model computes each task's
    function with the same numbers."""
    out: t.Dict[str, torch.Tensor] = {}
    parts: t.Dict[str, t.Dict[int, torch.Tensor]] = {}
    for key, value in state_dict.items():
        head, _, rest = key.partition(".")
        m = re.fullmatch(r"(.+)_task(\d+)", head)
        if m is None:
            out[key] = value
        else:
            parts.setdefault(f"{m.group(1)}_folded.{rest}", {})[int(m.group(2))] = value
    for key, by_task in parts.items():
        if sorted(by_task) != list(range(n_tasks)):
            raise ValueError(f"{key}: tasks {sorted(by_task)}, want 0..{n_tasks - 1}")
        out[key] = torch.stack([by_task[i] for i in range(n_tasks)])
    return out
