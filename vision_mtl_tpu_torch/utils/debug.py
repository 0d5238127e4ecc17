"""Debug helpers (counterpart of ``vision_mtl_tpu/utils/debug.py``)."""

from __future__ import annotations

import typing as t

import numpy as np
import torch


def get_module_by_name(tree: t.Any, access_string: str) -> t.Any:
    """Fetch a nested entry by dotted path from a state dict, a nested
    mapping or an ``nn.Module``, e.g. ``get_module_by_name(model,
    "backbone.encoder.conv")``. A state dict's flat dotted key is taken
    whole where it is present. Raises ``KeyError`` naming the path up to the
    failing segment."""
    if isinstance(tree, t.Mapping) and access_string in tree:
        return tree[access_string]
    node = tree
    seen: t.List[str] = []
    for name in access_string.split("."):
        seen.append(name)
        if isinstance(node, t.Mapping):
            if name not in node:
                raise KeyError(
                    f"{'.'.join(seen)!r} not in tree (available: {sorted(node)[:10]})"
                )
            node = node[name]
        elif hasattr(node, name):
            node = getattr(node, name)
        else:
            raise KeyError(
                f"{'.'.join(seen)!r}: node of type {type(node).__name__} "
                f"has no key/attribute {name!r}"
            )
    return node


def print_sample_stats(sample: t.Mapping[str, t.Any]) -> None:
    """Print each key's shape, range, median and dtype."""
    for k in sample:
        v = sample[k]
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        print(k)
        print(f"{arr.shape=}")
        print(f"{arr.min()=} {arr.max()=}")
        print(f" {np.median(arr)=} {arr.dtype=}")
        print("-" * 10)
