"""Weight bridge: load a JAX model's variables into the port's module.

``variables`` is the JAX ``{"params": ..., "batch_stats": ...}`` tree as
nested dicts of numpy arrays (what ``jax.device_get`` returns), under flax's
own paths, e.g. ``enc_dconv_0/ConvBNAct_0/Conv_0/Conv_0/kernel`` or
``enc_attn_0_task0/GateChain_0/w1``. The port's submodules carry the flax
names, so the bridge walks the torch module tree and reads, for each block,
the leaves that block's flax counterpart owns:

* ``Conv``: ``<path>/Conv_0/{kernel,bias}``, kernel HWIO -> OIHW;
* ``Conv``'s depthwise kernel (kh, kw, 1, O) becomes (O, 1, kh, kw);
* ``BatchNorm``: ``<path>/BatchNorm_0/{scale,bias}`` and the stats
  ``<path>/BatchNorm_0/{mean,var}``;
* ``RawBatchNorm`` (a flax ``nn.BatchNorm`` used directly, as the encoder's
  ``_stem_bn``): ``<path>/{scale,bias}`` and ``<path>/{mean,var}``;
* ``ConvTranspose``: ``<path>/{kernel,bias}``. flax's ConvTranspose does
  not flip its kernel and torch's does, so the kernel is flipped in kh, kw,
  then (kh, kw, in, out) -> (in, out, kh, kw);
* ``GateChain``: ``w1``/``w2`` as (in, out) matrices, ``b1, b2, scale1,
  bias1, scale2, bias2`` and the stats ``mean1, var1, mean2, var2`` as they
  are;
* ``CrossStitchLayer``: ``<path>/weights`` as it is.

It is strict: it raises on a missing leaf, a shape that does not fit, a
leaf it did not consume, and a port parameter or buffer it did not fill.
"""

from __future__ import annotations

import typing as t

import numpy as np
import torch
from torch import nn

from vision_mtl_tpu_torch.models.blocks import BatchNorm, Conv, ConvTranspose, RawBatchNorm
from vision_mtl_tpu_torch.models.cross_stitch import CrossStitchLayer
from vision_mtl_tpu_torch.models.mtan import GateChain

_Transform = t.Callable[[np.ndarray], np.ndarray]


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _conv_kernel(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)


def _conv_transpose_kernel(a: np.ndarray) -> np.ndarray:
    return a[::-1, ::-1].transpose(2, 3, 0, 1)


def _block_leaves(
    module: nn.Module, path: str
) -> t.Optional[t.List[t.Tuple[str, str, _Transform]]]:
    """(torch name, flax key, transform) for each tensor of a leaf block;
    None for a container, whose children carry the flax names."""
    path = f"{path}/" if path else ""
    if isinstance(module, Conv):
        leaves = [("weight", f"params/{path}Conv_0/kernel", _conv_kernel)]
        if module.bias is not None:
            leaves.append(("bias", f"params/{path}Conv_0/bias", _same))
        return leaves
    if isinstance(module, RawBatchNorm):
        return [
            ("weight", f"params/{path}scale", _same),
            ("bias", f"params/{path}bias", _same),
            ("running_mean", f"batch_stats/{path}mean", _same),
            ("running_var", f"batch_stats/{path}var", _same),
        ]
    if isinstance(module, BatchNorm):
        return [
            ("weight", f"params/{path}BatchNorm_0/scale", _same),
            ("bias", f"params/{path}BatchNorm_0/bias", _same),
            ("running_mean", f"batch_stats/{path}BatchNorm_0/mean", _same),
            ("running_var", f"batch_stats/{path}BatchNorm_0/var", _same),
        ]
    if isinstance(module, ConvTranspose):
        return [
            ("weight", f"params/{path}kernel", _conv_transpose_kernel),
            ("bias", f"params/{path}bias", _same),
        ]
    if isinstance(module, GateChain):
        names = ("w1", "b1", "w2", "b2", "scale1", "bias1", "scale2", "bias2")
        stats = ("mean1", "var1", "mean2", "var2")
        return [(n, f"params/{path}{n}", _same) for n in names] + [
            (n, f"batch_stats/{path}{n}", _same) for n in stats
        ]
    if isinstance(module, CrossStitchLayer):
        return [("weights", f"params/{path}weights", _same)]
    return None


def _flatten(tree: t.Mapping[str, t.Any], prefix: str, out: t.Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, t.Mapping):
            _flatten(v, key, out)
        else:
            out[key] = np.asarray(v)


def load_jax_variables(model: nn.Module, variables: t.Mapping[str, t.Any]) -> None:
    """Copy the JAX ``variables`` into ``model`` in place (see the module
    docstring for the mapping). Raises ``ValueError``, before changing any
    tensor, on any leaf or tensor left unmatched and on a shape that does
    not fit."""
    flat: t.Dict[str, np.ndarray] = {}
    for coll, tree in variables.items():
        _flatten(tree, coll, flat)
    state = model.state_dict(keep_vars=True)
    pending: t.Dict[str, np.ndarray] = {}  # torch key -> value, copied once all match
    consumed: t.Set[str] = set()
    missing: t.List[str] = []

    def walk(module: nn.Module, path: str, torch_prefix: str) -> None:
        leaves = _block_leaves(module, path)
        if leaves is None:
            for name, child in module.named_children():
                walk(child, f"{path}/{name}" if path else name, f"{torch_prefix}{name}.")
            return
        for torch_name, key, transform in leaves:
            if key not in flat:
                missing.append(key)
                continue
            target = state[torch_prefix + torch_name]
            value = transform(flat[key])
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"{key}: shape {value.shape} (after layout change) does not "
                    f"fit {torch_prefix}{torch_name} {tuple(target.shape)}"
                )
            pending[torch_prefix + torch_name] = value
            consumed.add(key)

    walk(model, "", "")
    unconsumed = sorted(set(flat) - consumed)
    unfilled = sorted(set(state) - set(pending))
    if missing or unconsumed or unfilled:
        raise ValueError(
            "JAX variables do not match the port's module:\n"
            f"  missing JAX leaves: {missing}\n"
            f"  JAX leaves not consumed: {unconsumed}\n"
            f"  port tensors not filled: {unfilled}"
        )
    with torch.no_grad():
        for name, value in pending.items():
            state[name].copy_(torch.tensor(np.ascontiguousarray(value)))
