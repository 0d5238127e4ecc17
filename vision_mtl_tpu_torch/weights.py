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

``jax_variables_from_model`` is its exact inverse: the same walk, each
layout change undone, gives the JAX tree of a port module.
"""

from __future__ import annotations

import typing as t

import numpy as np
import torch
from torch import nn

from vision_mtl_tpu_torch.models.blocks import BatchNorm, Conv, ConvTranspose, RawBatchNorm
from vision_mtl_tpu_torch.models.cross_stitch import CrossStitchLayer
from vision_mtl_tpu_torch.models.mtan import GateChain

# layout of a leaf: (JAX -> port, port -> JAX)
_LAYOUTS: t.Dict[str, t.Tuple[t.Callable[[np.ndarray], np.ndarray], ...]] = {
    "same": (lambda a: a, lambda a: a),
    # HWIO (depthwise: (kh, kw, 1, O)) <-> OIHW
    "conv": (lambda a: a.transpose(3, 2, 0, 1), lambda a: a.transpose(2, 3, 1, 0)),
    # flax's unflipped (kh, kw, in, out) <-> torch's flipped (in, out, kh, kw)
    "convt": (
        lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1),
        lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1],
    ),
}


def _block_leaves(module: nn.Module, path: str) -> t.Optional[t.List[t.Tuple[str, str, str]]]:
    """(torch name, flax key, layout) for each tensor of a leaf block; None
    for a container, whose children carry the flax names."""
    path = f"{path}/" if path else ""
    if isinstance(module, Conv):
        leaves = [("weight", f"params/{path}Conv_0/kernel", "conv")]
        if module.bias is not None:
            leaves.append(("bias", f"params/{path}Conv_0/bias", "same"))
        return leaves
    if isinstance(module, RawBatchNorm):
        return [
            ("weight", f"params/{path}scale", "same"),
            ("bias", f"params/{path}bias", "same"),
            ("running_mean", f"batch_stats/{path}mean", "same"),
            ("running_var", f"batch_stats/{path}var", "same"),
        ]
    if isinstance(module, BatchNorm):
        return [
            ("weight", f"params/{path}BatchNorm_0/scale", "same"),
            ("bias", f"params/{path}BatchNorm_0/bias", "same"),
            ("running_mean", f"batch_stats/{path}BatchNorm_0/mean", "same"),
            ("running_var", f"batch_stats/{path}BatchNorm_0/var", "same"),
        ]
    if isinstance(module, ConvTranspose):
        return [
            ("weight", f"params/{path}kernel", "convt"),
            ("bias", f"params/{path}bias", "same"),
        ]
    if isinstance(module, GateChain):
        names = ("w1", "b1", "w2", "b2", "scale1", "bias1", "scale2", "bias2")
        stats = ("mean1", "var1", "mean2", "var2")
        return [(n, f"params/{path}{n}", "same") for n in names] + [
            (n, f"batch_stats/{path}{n}", "same") for n in stats
        ]
    if isinstance(module, CrossStitchLayer):
        return [("weights", f"params/{path}weights", "same")]
    return None


def _leaves(model: nn.Module) -> t.List[t.Tuple[str, str, str]]:
    """(torch state key, flax key, layout) of every tensor the walk reaches,
    in module order."""
    out: t.List[t.Tuple[str, str, str]] = []

    def walk(module: nn.Module, path: str, torch_prefix: str) -> None:
        leaves = _block_leaves(module, path)
        if leaves is None:
            for name, child in module.named_children():
                walk(child, f"{path}/{name}" if path else name, f"{torch_prefix}{name}.")
            return
        out.extend((torch_prefix + name, key, layout) for name, key, layout in leaves)

    walk(model, "", "")
    return out


def _flatten(tree: t.Mapping[str, t.Any], prefix: str, out: t.Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, t.Mapping):
            _flatten(v, key, out)
        else:
            out[key] = np.asarray(v)


def port_tensors(model: nn.Module, variables: t.Mapping[str, t.Any]) -> t.Dict[str, np.ndarray]:
    """The JAX ``variables`` under ``model``'s state keys, each in the port's
    layout (see the module docstring for the mapping). Raises
    ``ValueError`` on any leaf or tensor left unmatched and on a shape that
    does not fit."""
    flat: t.Dict[str, np.ndarray] = {}
    for coll, tree in variables.items():
        _flatten(tree, coll, flat)
    state = model.state_dict(keep_vars=True)
    out: t.Dict[str, np.ndarray] = {}
    missing: t.List[str] = []
    leaves = _leaves(model)
    for torch_key, key, layout in leaves:
        if key not in flat:
            missing.append(key)
            continue
        value = _LAYOUTS[layout][0](flat[key])
        if tuple(value.shape) != tuple(state[torch_key].shape):
            raise ValueError(
                f"{key}: shape {value.shape} (after layout change) does not "
                f"fit {torch_key} {tuple(state[torch_key].shape)}"
            )
        out[torch_key] = np.ascontiguousarray(value)
    unconsumed = sorted(set(flat) - {key for _, key, _ in leaves})
    unfilled = sorted(set(state) - set(out))
    if missing or unconsumed or unfilled:
        raise ValueError(
            "JAX variables do not match the port's module:\n"
            f"  missing JAX leaves: {missing}\n"
            f"  JAX leaves not consumed: {unconsumed}\n"
            f"  port tensors not filled: {unfilled}"
        )
    return out


def load_jax_variables(model: nn.Module, variables: t.Mapping[str, t.Any]) -> None:
    """Copy the JAX ``variables`` into ``model`` in place
    (:func:`port_tensors`); raises before changing any tensor."""
    values = port_tensors(model, variables)
    state = model.state_dict(keep_vars=True)
    with torch.no_grad():
        for name, value in values.items():
            state[name].copy_(torch.tensor(value))


def jax_variables_from_model(
    model: nn.Module, tensors: t.Optional[t.Mapping[str, torch.Tensor]] = None
) -> t.Dict[str, t.Any]:
    """The JAX ``{"params": ..., "batch_stats": ...}`` tree of ``model``, as
    nested dicts of numpy arrays under flax's paths: the exact inverse of
    :func:`load_jax_variables`. ``tensors`` (torch state key to tensor)
    stands in for the module's own tensors where it has a key, so a
    parameter-shaped quantity, such as Adam's moments, takes the
    parameters' layout changes. Raises ``ValueError`` on a module tensor the
    walk does not reach."""
    state = model.state_dict()
    leaves = _leaves(model)
    unreached = sorted(set(state) - {torch_key for torch_key, _, _ in leaves})
    if unreached:
        raise ValueError(f"port tensors with no JAX leaf: {unreached}")
    out: t.Dict[str, t.Any] = {}
    for torch_key, key, layout in leaves:
        value = (tensors or {}).get(torch_key, state[torch_key])
        array = _LAYOUTS[layout][1](value.detach().cpu().numpy())
        node = out
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(array)
    return out
