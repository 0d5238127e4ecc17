"""ImageNet weights for the MobileNetV3-Large encoder (counterpart of
``vision_mtl_tpu/utils/torch_port.py``).

The reference's "(P)" configs start from imagenet-pretrained timm weights
through smp. This module maps a ``mobilenetv3_large_100`` state_dict (timm's
key layout, the layout inside smp's timm-mobilenetv3 encoder, prefixes
stripped) onto the port's encoder: first onto the JAX package's flax tree,
through the encoder's entry table that the reference checkpoints' import
also uses (``utils/ckpt_import.py``), then through
``weights.load_jax_variables`` onto the module, so the JAX package and the
port read one file the same way.

Weight sources (any one):
  * ``vision_mtl_tpu/weights/mobilenetv3_large_100.npz``, the JAX package's
    default file, read by path: one file serves both packages;
  * a torch ``.pt``/``.pth`` checkpoint path.

No file is in the repo and none can be fetched: when none is found the
loader says so and leaves the model's weights as they are.
"""

from __future__ import annotations

import os
import typing as t

import numpy as np
import torch
from torch import nn

from vision_mtl_tpu_torch.weights import load_jax_variables

Tree = t.Dict[str, t.Any]

WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "vision_mtl_tpu", "weights",
)
DEFAULT_WEIGHTS = os.path.join(WEIGHTS_DIR, "mobilenetv3_large_100.npz")


def _set(tree: Tree, path: t.Sequence[str], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def convert_encoder_state_dict(sd: t.Mapping[str, np.ndarray]) -> t.Tuple[Tree, Tree]:
    """timm mobilenetv3_large_100 state_dict -> (params, batch_stats) trees
    of the encoder under flax's paths, through the encoder's entry table in
    ``utils/ckpt_import.py`` (the one the reference checkpoints' import
    uses)."""
    from vision_mtl_tpu_torch.utils.ckpt_import import _FWD, _mobilenetv3_entries

    params: Tree = {}
    stats: Tree = {}
    for torch_key, col, path, kind in _mobilenetv3_entries("", ()):
        _set(params if col == "params" else stats, path, _FWD[kind](np.asarray(sd[torch_key])))
    return params, stats


def load_state_dict_file(path: str) -> t.Dict[str, np.ndarray]:
    """A state_dict from ``.npz`` or a torch file (``torch.load`` with
    ``weights_only=True``), unwrapped from a lightning-style
    ``{"state_dict": ...}`` or the reference's ``{"model": ...}``, as numpy
    arrays."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(sd, dict) and wrapper in sd and isinstance(sd[wrapper], dict):
            sd = sd[wrapper]
    return {
        k: (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
        for k, v in sd.items()
    }


def _strip_prefix(sd: t.Dict[str, np.ndarray]) -> t.Dict[str, np.ndarray]:
    """Strip smp/timm wrapper prefixes like 'encoder.model.' or 'model.'."""
    for prefix in ("encoder.model.", "model.", ""):
        if any(k.startswith(prefix + "conv_stem") for k in sd):
            return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


def apply_imagenet_backbone(
    model: nn.Module, model_name: str, weights_path: t.Optional[str] = None
) -> bool:
    """Load converted encoder weights into ``model`` in place: basic's
    ``backbone.encoder``, every ``encoders_{i}`` of CSNet. MTAN has no
    imagenet backbone (the reference trains it from scratch). Returns
    whether weights were loaded."""
    path = weights_path or DEFAULT_WEIGHTS
    alt = path.replace(".npz", ".pth")
    if not os.path.exists(path) and os.path.exists(alt):
        path = alt
    if not os.path.exists(path):
        print(
            f"[torch_port] no imagenet weights at {path}; training from "
            f"scratch (zero-egress environment — place a timm "
            f"mobilenetv3_large_100 state_dict there to enable)."
        )
        return False
    if model_name == "basic":
        encoders = [model.backbone.encoder]
    elif model_name == "csnet":
        encoders = [m for name, m in model.named_children() if name.startswith("encoders_")]
    else:
        print(f"[torch_port] model {model_name} has no imagenet backbone")
        return False
    enc_params, enc_stats = convert_encoder_state_dict(_strip_prefix(load_state_dict_file(path)))
    for encoder in encoders:
        load_jax_variables(encoder, {"params": enc_params, "batch_stats": enc_stats})
    print(f"[torch_port] loaded imagenet backbone from {path}")
    return True
