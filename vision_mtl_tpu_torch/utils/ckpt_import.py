"""Reference-checkpoint interop: torch ``model_{epoch}.pt`` <-> the port's
modules (counterpart of ``vision_mtl_tpu/utils/ckpt_import.py``).

Users of the original PyTorch ``vision_mtl`` hold runs as ``model_{e}.pt``
(``{"model": MTLModule.state_dict()}``) and ``session_{e}.pt`` (the torch
Adam's and the plateau scheduler's state dicts and ``epoch``). The JAX
package's ``scripts/export_torch_ckpt.py`` writes the same format, so it is
also the way a JAX run reaches the port. This module imports both files
into the port (evaluate, serve, warm-start or continue a run) and exports a
port model back into the reference's format.

Each architecture's layout is ONE declarative table of ``(torch_key,
collection, flax_path, transform)`` entries, the JAX package's own. Import
applies it (reference state_dict -> the JAX ``{"params", "batch_stats"}``
tree) and hands the tree to ``weights.load_jax_variables``; export reads
the JAX tree of the module (``weights.jax_variables_from_model``) and
inverts it. Where the reference and the port share torch's layout (convs,
transposed convs, BatchNorm) the two layout changes of a leaf cancel: the
reference's tensor lands in the port unchanged (tested). Only the attention
gates' 1x1 convs change layout, (out, in, 1, 1) -> the GateChain's (in,
out) matrices, and their Adam moments with them.

Real reference checkpoints carry the Lightning wrapper's ``model.`` prefix
on every key (reference pipeline_utils.py:150-155 via training_lit.py:173);
import strips it (``normalize_reference_state_dict``), export adds it back
by default, with ``num_batches_tracked = 0`` beside every BatchNorm. Import
consumes and ignores ``num_batches_tracked``. The reference's running
variance is torch's unbiased one and is copied as it is.

Source layouts (bare-model keys, after the wrapper prefix):

* **basic**: ``backbone.encoder.model.*`` (timm mobilenetv3_large_100 inside
  smp's encoder), ``backbone.decoder.blocks.{i}.conv{1,2}.{0,1}`` (smp 0.3.3
  Conv2dReLU: bias-free conv, BN), ``{segm,depth}_head.0.{weight,bias}``;
  the port keeps both heads at their own paths (merged only in its forward).
* **mtan**: ``enc_layers.{i}.dconv.double_conv.{0,1,3,4}``,
  ``enc_layers.{i}.task_attn_modules.{t}.{conv,bn}{1,2,3}``,
  ``bottleneck.double_conv.*``, ``dec_layers.{i}.up``,
  ``dec_layers.{i}.conv.double_conv.*``,
  ``dec_layers.{i}.task_attn_modules.{t}.{conv1,bn1,conv2,bn2,conv3,bn3,
  conv_out,bn_out}``, ``map_tasks_to_heads.{task}``.
* **csnet**: ``models.{task}.0.encoder.model.*``,
  ``models.{task}.0.decoder.blocks.*``, ``models.{task}.1.0.{weight,bias}``
  and ``cross_stitch_layers.{name}.weights`` with ``name`` in
  ``0_encoder_model_blocks_{1..6}`` and ``0_decoder_blocks_{0..4}``; (T, T)
  layer-wise or (T, T, C) channel-wise.

The smp sub-layouts are pinned to segmentation-models-pytorch==0.3.3, so the
importer verifies the keys it consumed against the checkpoint and fails with
an explicit missing/unused diff instead of mis-assigning silently.
"""

from __future__ import annotations

import os
import pickle
import re
import typing as t

import numpy as np
import torch
from torch import nn

from vision_mtl_tpu_torch.models.mobilenetv3 import MOBILENETV3_LARGE_SPECS
from vision_mtl_tpu_torch.utils.torch_port import Tree, _set, load_state_dict_file
from vision_mtl_tpu_torch.weights import (
    jax_variables_from_model,
    load_jax_variables,
    port_tensors,
)

# ----------------------------------------------------------- entry machinery

# (torch_key, collection "params"|"batch_stats", flax path, transform kind)
Entry = t.Tuple[str, str, t.Tuple[str, ...], str]

_FWD: t.Dict[str, t.Callable[[np.ndarray], np.ndarray]] = {
    # torch OIHW conv kernel -> flax HWIO
    "conv": lambda w: np.transpose(w, (2, 3, 1, 0)),
    # torch ConvTranspose2d (in,out,kh,kw) -> flax (kh,kw,in,out), spatial
    # dims flipped (flax does not flip the kernel; torch does)
    "convt": lambda w: np.flip(np.transpose(w, (2, 3, 0, 1)), axis=(0, 1)).copy(),
    # torch 1x1 conv (out,in,1,1) -> GateChain matmul weight (in,out)
    "gate_w": lambda w: np.transpose(w[:, :, 0, 0], (1, 0)),
    "direct": lambda w: np.asarray(w),
}

_INV: t.Dict[str, t.Callable[[np.ndarray], np.ndarray]] = {
    "conv": lambda k: np.transpose(k, (3, 2, 0, 1)),
    "convt": lambda k: np.transpose(np.flip(k, axis=(0, 1)), (2, 3, 0, 1)).copy(),
    "gate_w": lambda k: np.transpose(k, (1, 0))[:, :, None, None].copy(),
    "direct": lambda k: np.asarray(k),
}


def _bn_entries(tp: str, path: t.Sequence[str]) -> t.List[Entry]:
    p = tuple(path)
    return [
        (f"{tp}.weight", "params", p + ("scale",), "direct"),
        (f"{tp}.bias", "params", p + ("bias",), "direct"),
        (f"{tp}.running_mean", "batch_stats", p + ("mean",), "direct"),
        (f"{tp}.running_var", "batch_stats", p + ("var",), "direct"),
    ]


def _conv_entries(
    tp: str, path: t.Sequence[str], bias: bool, kind: str = "conv"
) -> t.List[Entry]:
    p = tuple(path)
    out: t.List[Entry] = [(f"{tp}.weight", "params", p + ("kernel",), kind)]
    if bias:
        out.append((f"{tp}.bias", "params", p + ("bias",), "direct"))
    return out


def _dconv_entries(tp: str, path: t.Sequence[str]) -> t.List[Entry]:
    """Reference DoubleConv: Sequential indices 0/3 = bias-free conv3x3,
    1/4 = BN -> DoubleConv's ConvBNAct_{0,1}."""
    out: t.List[Entry] = []
    for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
        base = tuple(path) + (f"ConvBNAct_{j}",)
        out += _conv_entries(f"{tp}.double_conv.{ci}", base + ("Conv_0", "Conv_0"), bias=False)
        out += _bn_entries(f"{tp}.double_conv.{bi}", base + ("BatchNorm_0", "BatchNorm_0"))
    return out


def _smp_decoder_block_entries(tp: str, path: t.Sequence[str]) -> t.List[Entry]:
    """One smp 0.3.3 DecoderBlock: conv1/conv2 are Conv2dReLU =
    Sequential(conv-bias-free, bn, relu)."""
    out: t.List[Entry] = []
    for j in range(2):
        base = tuple(path) + (f"ConvBNAct_{j}",)
        out += _conv_entries(f"{tp}.conv{j + 1}.0", base + ("Conv_0", "Conv_0"), bias=False)
        out += _bn_entries(f"{tp}.conv{j + 1}.1", base + ("BatchNorm_0", "BatchNorm_0"))
    return out


def _gate_chain_entries(tp: str, path: t.Sequence[str]) -> t.List[Entry]:
    """Reference attention-gate pair conv1/bn1 + conv2/bn2 (both 1x1, with
    bias) -> GateChain's w/b/scale/bias params + mean/var stats."""
    p = tuple(path)
    out: t.List[Entry] = []
    for n in (1, 2):
        out += [
            (f"{tp}.conv{n}.weight", "params", p + (f"w{n}",), "gate_w"),
            (f"{tp}.conv{n}.bias", "params", p + (f"b{n}",), "direct"),
            (f"{tp}.bn{n}.weight", "params", p + (f"scale{n}",), "direct"),
            (f"{tp}.bn{n}.bias", "params", p + (f"bias{n}",), "direct"),
            (f"{tp}.bn{n}.running_mean", "batch_stats", p + (f"mean{n}",), "direct"),
            (f"{tp}.bn{n}.running_var", "batch_stats", p + (f"var{n}",), "direct"),
        ]
    return out


def _mobilenetv3_entries(tp: str, base: t.Sequence[str]) -> t.List[Entry]:
    """timm mobilenetv3_large_100 feature path -> MobileNetV3Encoder; ``tp``
    is the encoder's key prefix ("" for a bare timm state_dict, as
    ``torch_port.convert_encoder_state_dict`` reads it)."""
    pre = f"{tp}." if tp else ""
    b = tuple(base)
    out: t.List[Entry] = []
    out += _conv_entries(f"{pre}conv_stem", b + ("conv_stem", "Conv_0"), False)
    out += _bn_entries(f"{pre}bn1", b + ("_stem_bn",))
    for si, stage in enumerate(MOBILENETV3_LARGE_SPECS):
        for bi, spec in enumerate(stage):
            tpb = f"{pre}blocks.{si}.{bi}"
            fp = b + (f"stages_{si}_{bi}",)
            if spec.ds:
                out += _conv_entries(f"{tpb}.conv_dw", fp + ("Conv_0", "Conv_0"), False)
                out += _bn_entries(f"{tpb}.bn1", fp + ("BatchNorm_0", "BatchNorm_0"))
                out += _conv_entries(f"{tpb}.conv_pw", fp + ("Conv_1", "Conv_0"), False)
                out += _bn_entries(f"{tpb}.bn2", fp + ("BatchNorm_1", "BatchNorm_0"))
            else:
                out += _conv_entries(f"{tpb}.conv_pw", fp + ("Conv_0", "Conv_0"), False)
                out += _bn_entries(f"{tpb}.bn1", fp + ("BatchNorm_0", "BatchNorm_0"))
                out += _conv_entries(f"{tpb}.conv_dw", fp + ("Conv_1", "Conv_0"), False)
                out += _bn_entries(f"{tpb}.bn2", fp + ("BatchNorm_1", "BatchNorm_0"))
                if spec.se:
                    out += _conv_entries(
                        f"{tpb}.se.conv_reduce", fp + ("SqueezeExcite_0", "Conv_0", "Conv_0"),
                        bias=True,
                    )
                    out += _conv_entries(
                        f"{tpb}.se.conv_expand", fp + ("SqueezeExcite_0", "Conv_1", "Conv_0"),
                        bias=True,
                    )
                out += _conv_entries(f"{tpb}.conv_pwl", fp + ("Conv_2", "Conv_0"), False)
                out += _bn_entries(f"{tpb}.bn3", fp + ("BatchNorm_2", "BatchNorm_0"))
    # timm blocks.6.0 (ConvBnAct) is the encoder's conv head
    out += _conv_entries(f"{pre}blocks.6.0.conv", b + ("conv_head", "Conv_0"), False)
    out += _bn_entries(f"{pre}blocks.6.0.bn1", b + ("_head_bn",))
    return out


# --------------------------------------------------------- per-model mappings
def _basic_mapping(num_decoder_layers: int = 5) -> t.List[Entry]:
    out = _mobilenetv3_entries("backbone.encoder.model", ("backbone", "encoder"))
    for i in range(num_decoder_layers):
        out += _smp_decoder_block_entries(
            f"backbone.decoder.blocks.{i}", ("backbone", "decoder", f"block_{i}")
        )
    for head in ("segm_head", "depth_head"):
        out += _conv_entries(f"{head}.0", (head, "Conv_0", "Conv_0"), bias=True)
    return out


def _mtan_mapping(
    task_names: t.Sequence[str] = ("depth", "segm"),
    encoder_num_channels: int = 4,
) -> t.List[Entry]:
    out: t.List[Entry] = []

    def attn_enc(tm: str, fm: str) -> t.List[Entry]:
        # AttentionModuleEncoder: gate pair, then conv3/bn3 = the 3x3
        # output conv (conv3 has bias)
        e = _gate_chain_entries(tm, (fm, "GateChain_0"))
        e += _conv_entries(f"{tm}.conv3", (fm, "Conv_0", "Conv_0"), bias=True)
        e += _bn_entries(f"{tm}.bn3", (fm, "BatchNorm_0", "BatchNorm_0"))
        return e

    def attn_dec(tm: str, fm: str) -> t.List[Entry]:
        # AttentionModuleDecoder: conv1/bn1+conv2/bn2 the gate chain,
        # conv3/bn3 the PREV-stream 3x3 conv (Conv_0/BatchNorm_0),
        # conv_out/bn_out the 3x3 output conv. In the reference's
        # registration order (the JAX package's table starts with conv3), so
        # an export's keys run in the reference module's parameter order,
        # which a session's optimizer indices follow
        e = _gate_chain_entries(tm, (fm, "GateChain_0"))
        e += _conv_entries(f"{tm}.conv3", (fm, "Conv_0", "Conv_0"), bias=True)
        e += _bn_entries(f"{tm}.bn3", (fm, "BatchNorm_0", "BatchNorm_0"))
        e += _conv_entries(f"{tm}.conv_out", (fm, "Conv_1", "Conv_0"), bias=True)
        e += _bn_entries(f"{tm}.bn_out", (fm, "BatchNorm_1", "BatchNorm_0"))
        return e

    for i in range(encoder_num_channels):
        out += _dconv_entries(f"enc_layers.{i}.dconv", (f"enc_dconv_{i}",))
        for ti in range(len(task_names)):
            out += attn_enc(f"enc_layers.{i}.task_attn_modules.{ti}", f"enc_attn_{i}_task{ti}")
    out += _dconv_entries("bottleneck", ("bottleneck",))
    for i in range(encoder_num_channels):
        out += _conv_entries(f"dec_layers.{i}.up", (f"dec_up_{i}",), bias=True, kind="convt")
        out += _dconv_entries(f"dec_layers.{i}.conv", (f"dec_dconv_{i}",))
        for ti in range(len(task_names)):
            out += attn_dec(f"dec_layers.{i}.task_attn_modules.{ti}", f"dec_attn_{i}_task{ti}")
    for task in task_names:
        out += _conv_entries(f"map_tasks_to_heads.{task}", (f"head_{task}", "Conv_0"), bias=True)
    return out


def _csnet_mapping(
    task_names: t.Sequence[str] = ("depth", "segm"),
    num_decoder_layers: int = 5,
) -> t.List[Entry]:
    out: t.List[Entry] = []
    for ti, task in enumerate(task_names):
        out += _mobilenetv3_entries(f"models.{task}.0.encoder.model", (f"encoders_{ti}",))
        # CSNet drives DecoderBlocks directly (decoders_{ti}_{d}), not
        # through a UnetDecoder wrapper: the same ConvBNAct layout inside
        for d in range(num_decoder_layers):
            out += _smp_decoder_block_entries(
                f"models.{task}.0.decoder.blocks.{d}", (f"decoders_{ti}_{d}",)
            )
        out += _conv_entries(f"models.{task}.1.0", (f"heads_{ti}", "Conv_0", "Conv_0"), bias=True)
    # stitch names: the reference's module-walk selects encoder blocks 1..6
    # and decoder blocks 0..4, named by their dotted paths with dots
    # replaced by underscores
    for k in range(1, 7):
        out.append((f"cross_stitch_layers.0_encoder_model_blocks_{k}.weights", "params",
                    (f"enc_stitches_{k - 1}", "weights"), "direct"))
    for d in range(num_decoder_layers):
        out.append((f"cross_stitch_layers.0_decoder_blocks_{d}.weights", "params",
                    (f"dec_stitches_{d}", "weights"), "direct"))
    return out


_MAPPINGS: t.Dict[str, t.Callable[[], t.List[Entry]]] = {
    "basic": _basic_mapping,
    "mtan": _mtan_mapping,
    "csnet": _csnet_mapping,
}

# real smp timm encoders may carry classifier-tail params the feature path
# never uses: tolerate unconsumed keys inside the timm encoder subtrees
# only (anything else unconsumed is a layout bug)
_TOLERATED_EXTRA_PATTERNS: t.Dict[str, t.Tuple[str, ...]] = {
    "basic": (r"backbone\.encoder\.model\..*",),
    "mtan": (),
    "csnet": (r"models\.[^.]+\.0\.encoder\.model\..*",),
}


class _RecordingSD:
    """Wraps a state_dict, recording consumed keys and collecting misses so
    a layout mismatch surfaces as ONE diff, not the first KeyError."""

    def __init__(self, sd: t.Mapping[str, np.ndarray], tolerated_patterns: t.Sequence[str] = ()):
        self.sd = dict(sd)
        self.used: t.Set[str] = set()
        self.missing: t.List[str] = []
        self.tolerated = tuple(tolerated_patterns)

    def __getitem__(self, key: str) -> np.ndarray:
        if key not in self.sd:
            self.missing.append(key)
            # a 4-d placeholder survives every transform, so all misses
            # gather into one diff
            return np.zeros((1, 1, 1, 1), np.float32)
        self.used.add(key)
        return np.asarray(self.sd[key])

    def unused(self) -> t.List[str]:
        return sorted(
            k for k in self.sd
            if k not in self.used
            and not k.endswith("num_batches_tracked")
            and not any(re.fullmatch(p, k) for p in self.tolerated)
        )


def _convert(name: str, sd: t.Mapping[str, np.ndarray]) -> t.Tuple[Tree, Tree, _RecordingSD]:
    """Reference state_dict -> (params, batch_stats, record) under flax's
    paths."""
    rec = _RecordingSD(sd, _TOLERATED_EXTRA_PATTERNS[name])
    params: Tree = {}
    stats: Tree = {}
    for torch_key, col, path, kind in _MAPPINGS[name]():
        _set(params if col == "params" else stats, list(path), _FWD[kind](rec[torch_key]))
    return params, stats, rec


# ------------------------------------------------------------- normalization
_REFERENCE_ROOTS = ("backbone.", "enc_layers.", "models.")


def normalize_reference_state_dict(sd: t.Mapping[str, np.ndarray]) -> t.Dict[str, np.ndarray]:
    """Strip the Lightning wrapper's ``model.`` level (dropping any
    wrapper-level extras); bare-model state dicts pass through unchanged."""
    stripped = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    if stripped and any(k.startswith(r) for k in stripped for r in _REFERENCE_ROOTS):
        return stripped
    return dict(sd)


# ----------------------------------------------------------------- export
def _get_path(tree: t.Any, path: t.Sequence[str]) -> np.ndarray:
    node = tree
    for k in path:
        node = node[k]
    return np.asarray(node)


def export_reference_checkpoint(
    model_name: str,
    model: t.Union[nn.Module, t.Mapping[str, t.Any]],
    module_level: bool = True,
) -> t.Dict[str, np.ndarray]:
    """A port module (or its JAX variable tree) -> a state_dict in the
    REFERENCE's torch key layout, the exact inverse of
    :func:`import_reference_checkpoint`. Emits ``num_batches_tracked = 0``
    beside every BN, after its running variance as torch orders them, so
    MTAN's keys run in the reference module's own order. ``module_level``
    (default) prefixes every key with ``model.``, the Lightning level the
    reference's own load consumes; pass False for a bare-model
    state_dict."""
    if model_name not in _MAPPINGS:
        raise ValueError(f"unknown model_name {model_name!r}")
    variables = jax_variables_from_model(model) if isinstance(model, nn.Module) else model
    prefix = "model." if module_level else ""
    sd: t.Dict[str, np.ndarray] = {}
    for torch_key, col, path, kind in _MAPPINGS[model_name]():
        try:
            leaf = _get_path(variables[col], path)
        except (KeyError, TypeError):
            raise ValueError(
                f"model variables are missing {col}/{'/'.join(path)} — "
                f"wrong --model_name or architecture flags for this export?"
            ) from None
        sd[prefix + torch_key] = _INV[kind](leaf.astype(np.float32))
        if torch_key.endswith(".running_var"):
            sd[prefix + torch_key.rsplit(".", 1)[0] + ".num_batches_tracked"] = np.asarray(
                0, np.int64
            )
    return sd


def save_reference_checkpoint(
    path: str,
    model_name: str,
    model: t.Union[nn.Module, t.Mapping[str, t.Any]],
    module_level: bool = True,
) -> None:
    """Write an exported checkpoint as a ``.pt`` in the reference's save
    format (``{"model": state_dict}``), or ``.npz`` when the path ends so."""
    sd = export_reference_checkpoint(model_name, model, module_level=module_level)
    if path.endswith(".npz"):
        np.savez(path, **sd)
        return
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, path)


def load_reference_session(path: str) -> t.Dict[str, t.Any]:
    """Load a reference ``session_{e}.pt`` (optimizer, scheduler, epoch)
    with ``weights_only=True``; a file that needs more raises naming it."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as e:
        raise ValueError(
            f"{path}: not loadable with torch.load(weights_only=True) ({e}); the port "
            "reads reference sessions only as tensors, numbers, strings and containers"
        ) from e


def import_model(model: nn.Module, sd: t.Mapping[str, np.ndarray]) -> nn.Module:
    """Load a reference checkpoint into ``model`` in place, the architecture
    inferred from the normalized key layout."""
    sd = normalize_reference_state_dict(sd)
    return import_reference_checkpoint(infer_reference_model_name(sd), sd, model)


def import_into_state(state: t.Any, sd: t.Mapping[str, np.ndarray]) -> t.Any:
    """Replace a TrainState's weights and BN statistics with a reference
    checkpoint's (:func:`import_model`)."""
    import_model(state.model, sd)
    return state


# ----------------------------------------------------------------- import
def _tree_paths(tree: t.Any, prefix: str = "") -> t.Dict[str, t.Tuple[int, ...]]:
    out: t.Dict[str, t.Tuple[int, ...]] = {}
    if isinstance(tree, t.Mapping):
        for k, v in tree.items():
            out.update(_tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    out[prefix] = tuple(np.shape(tree))
    return out


def reference_stitching_is_channel_wise(sd: t.Mapping[str, np.ndarray]) -> t.Optional[bool]:
    """Whether a CSNet checkpoint's stitch units are channel-wise (T, T, C)
    rather than layer-wise (T, T); None when it has none."""
    sd = normalize_reference_state_dict(sd)
    for k, v in sd.items():
        if k.startswith("cross_stitch_layers.") and k.endswith(".weights"):
            return np.ndim(v) == 3
    return None


def import_reference_checkpoint(
    model_name: str,
    sd_or_path: t.Union[str, t.Mapping[str, np.ndarray]],
    model: nn.Module,
) -> nn.Module:
    """Load a full reference checkpoint into ``model`` in place (strict both
    ways) and return it. Raises ValueError with an explicit diff, before
    changing any tensor, when the checkpoint does not cover the model (or
    vice versa): wrong architecture flags, or an smp layout drift."""
    if model_name not in _MAPPINGS:
        raise ValueError(f"unknown model_name {model_name!r}")
    sd = load_state_dict_file(sd_or_path) if isinstance(sd_or_path, str) else sd_or_path
    sd = normalize_reference_state_dict(sd)
    params, stats, rec = _convert(model_name, sd)

    problems: t.List[str] = []
    if rec.missing:
        problems.append(
            f"checkpoint is missing {len(rec.missing)} expected key(s): "
            + ", ".join(rec.missing[:15]) + (" ..." if len(rec.missing) > 15 else "")
        )
    unused = rec.unused()
    if unused:
        problems.append(
            f"{len(unused)} checkpoint key(s) were not consumed: "
            + ", ".join(unused[:15]) + (" ..." if len(unused) > 15 else "")
        )
    if model_name == "csnet":
        channel_wise = reference_stitching_is_channel_wise(sd)
        built = model.enc_stitches_0.weights.dim() == 3
        if channel_wise is not None and channel_wise != built:
            problems.append(
                f"the checkpoint's stitch units are {'channel' if channel_wise else 'layer'}-wise, "
                f"the model's {'channel' if built else 'layer'}-wise "
                f"(channel_wise_stitching={built})"
            )

    converted = {"params": params, "batch_stats": stats}
    variables = jax_variables_from_model(model)
    for col in ("params", "batch_stats"):
        want = _tree_paths(variables[col])
        got = _tree_paths(converted[col])
        only_want = sorted(set(want) - set(got))
        only_got = sorted(set(got) - set(want))
        mismatched = sorted(p for p in set(want) & set(got) if want[p] != got[p])
        if only_want:
            problems.append(
                f"{col}: model expects {len(only_want)} leaf/leaves the "
                f"checkpoint did not provide: " + ", ".join(only_want[:10])
                + (" ..." if len(only_want) > 10 else "")
            )
        if only_got:
            problems.append(
                f"{col}: checkpoint provided {len(only_got)} unexpected "
                f"leaf/leaves: " + ", ".join(only_got[:10])
                + (" ..." if len(only_got) > 10 else "")
            )
        for p in mismatched[:10]:
            problems.append(f"{col}: {p} shape {got[p]} != model {want[p]}")
    if problems:
        raise ValueError(
            f"reference checkpoint does not match the {model_name!r} model "
            "architecture:\n  - " + "\n  - ".join(problems)
            + "\nCheck --model_name and architecture flags "
            "(--channel_wise_stitching, decoder widths); if the checkpoint "
            "predates smp==0.3.3 the decoder key layout may differ "
            "(vision_mtl_tpu_torch/utils/ckpt_import.py docstring)."
        )
    load_jax_variables(model, converted)
    return model


# ----------------------------------------------------------------- session
_BUFFER_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def reference_param_order(model_sd: t.Mapping[str, np.ndarray]) -> t.List[str]:
    """The reference's ``model.parameters()`` order, recovered from its
    state_dict: registration order with the BN buffers left out, which is
    how torch optimizer state_dicts index their per-param state."""
    return [k for k in model_sd if not any(k.endswith(s) for s in _BUFFER_SUFFIXES)]


def _moments_by_port_name(
    name: str, model: nn.Module, reference_moments: t.Mapping[str, np.ndarray],
    model_sd: t.Mapping[str, np.ndarray],
) -> t.Dict[str, np.ndarray]:
    """Per-parameter reference moments -> the same moments under the port's
    parameter names, each through its weight's own layout changes (Adam is
    elementwise). The BN buffers ride along only to fill the tree."""
    sd = {k: np.asarray(v) for k, v in model_sd.items() if k.endswith(_BUFFER_SUFFIXES)}
    sd.update(reference_moments)
    params, stats, rec = _convert(name, sd)
    if rec.missing:
        raise ValueError(
            "session import could not map optimizer moments: missing " + ", ".join(rec.missing[:10])
        )
    values = port_tensors(model, {"params": params, "batch_stats": stats})
    return {n: values[n] for n, _ in model.named_parameters()}


def import_reference_session(
    model_sd: t.Mapping[str, np.ndarray],
    session_sd: t.Mapping[str, t.Any],
    state: t.Any,
    scheduler: t.Any,
) -> t.Tuple[t.Any, t.Any, int]:
    """Import the reference's ``session_{e}.pt`` (torch Adam's moments and
    step, the lr, ReduceLROnPlateau's state, the epoch) into the port's
    TrainState and scheduler, so a reference run continues with the exact
    optimizer trajectory. Moments are mapped by NAME: the reference's
    position ``i`` is the i-th key of :func:`reference_param_order`, which
    the entry table and the weight bridge take to a port parameter; the
    port's Adam has its own parameter order. Every parameter's step is the
    largest step in the session, as the JAX package's single count.

    Returns ``(state, scheduler, start_epoch)`` like
    ``train.checkpoint.restore_session``."""
    model_sd = normalize_reference_state_dict(model_sd)
    name = infer_reference_model_name(model_sd)
    order = reference_param_order(model_sd)
    opt = session_sd["optimizer"]
    osd = opt["state"]
    groups = opt.get("param_groups", [])
    idxs = list(groups[0]["params"]) if groups else sorted(int(i) for i in osd)
    if len(idxs) != len(order):
        raise ValueError(
            f"optimizer state has {len(idxs)} params but the model "
            f"state_dict implies {len(order)} — model/session mismatch"
        )

    def entry(idx: t.Any) -> t.Mapping[str, t.Any]:
        return osd[idx if idx in osd else str(idx)]

    moments = {
        field: _moments_by_port_name(
            name, state.model,
            {order[pos]: np.asarray(entry(idx)[field]) for pos, idx in enumerate(idxs)}, model_sd,
        )
        for field in ("exp_avg", "exp_avg_sq")
    }
    # torch Adam's step is a tensor in newer torch, a number in older
    count = max((int(float(np.asarray(entry(i)["step"]))) for i in idxs), default=0)

    port_sd = state.optimizer.state_dict()
    names = [n for n, _ in state.model.named_parameters()]
    port_sd["state"] = {
        i: {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.from_numpy(moments["exp_avg"][n]),
            "exp_avg_sq": torch.from_numpy(moments["exp_avg_sq"][n]),
        }
        for i, n in enumerate(names)
    }
    if groups and "lr" in groups[0]:
        for group in port_sd["param_groups"]:
            group["lr"] = float(groups[0]["lr"])
    state.optimizer.load_state_dict(port_sd)
    state.step = count

    sch = session_sd.get("scheduler") or {}
    mapped = {
        k: sch[k]
        for k in ("patience", "factor", "threshold", "best", "num_bad_epochs")
        if k in sch
    }
    if "min_lrs" in sch and sch["min_lrs"]:
        mapped["min_lr"] = sch["min_lrs"][0]
    scheduler.load_state_dict(mapped)
    return state, scheduler, int(session_sd.get("epoch", 0)) + 1


def export_reference_session(
    model_name: str, state: t.Any, scheduler: t.Any, epoch: int
) -> t.Dict[str, t.Any]:
    """The port's TrainState and scheduler as the reference's session dict
    (``{"optimizer", "scheduler", "epoch"}`` in torch Adam's and
    ReduceLROnPlateau's state dict layouts): Adam's moments re-keyed into
    the reference's parameter order, each through its weight's layout
    changes. The inverse of :func:`import_reference_session` for a state
    whose parameters share one step."""
    model = state.model
    named = dict(model.named_parameters())
    opt_state = state.optimizer.state
    steps = {float(opt_state[p]["step"]) for p in named.values()}
    if len(steps) != 1:
        raise ValueError(f"the parameters' Adam steps differ: {sorted(steps)}")
    (step,) = steps
    moments = {
        field: export_reference_checkpoint(
            model_name,
            jax_variables_from_model(model, {n: opt_state[p][field] for n, p in named.items()}),
            module_level=False,
        )
        for field in ("exp_avg", "exp_avg_sq")
    }
    order = reference_param_order(moments["exp_avg"])
    group = {k: v for k, v in state.optimizer.param_groups[0].items() if k != "params"}
    sch = scheduler.state_dict()
    return {
        "optimizer": {
            "state": {
                i: {
                    "step": torch.tensor(step),
                    "exp_avg": torch.from_numpy(moments["exp_avg"][k]),
                    "exp_avg_sq": torch.from_numpy(moments["exp_avg_sq"][k]),
                }
                for i, k in enumerate(order)
            },
            "param_groups": [{**group, "params": list(range(len(order)))}],
        },
        "scheduler": {
            "factor": sch["factor"], "min_lrs": [sch["min_lr"]], "patience": sch["patience"],
            "cooldown": 0, "cooldown_counter": 0, "mode": "min", "threshold": sch["threshold"],
            "threshold_mode": "rel", "best": sch["best"], "num_bad_epochs": sch["num_bad_epochs"],
            "mode_worse": float("inf"), "eps": 1e-8, "last_epoch": epoch + 1,
        },
        "epoch": epoch,
    }


def infer_reference_model_name(sd: t.Mapping[str, t.Any]) -> str:
    """Which reference architecture produced this state_dict: the three
    layouts have disjoint roots, so the root prefix decides (and a wrong
    inference still fails in the importer's diff)."""
    for prefix, name in (("models.", "csnet"), ("enc_layers.", "mtan"), ("backbone.", "basic")):
        if any(k.startswith(prefix) for k in sd):
            return name
    raise ValueError(
        "state_dict does not look like any reference architecture (no "
        "'backbone.'/'enc_layers.'/'models.' keys) — got roots: "
        + ", ".join(sorted({k.split(".")[0] for k in sd})[:8])
    )


def find_reference_checkpoint(ckpt_dir: str) -> t.Optional[str]:
    """Latest-epoch ``model_{e}.pt`` in ``ckpt_dir`` (the reference's
    selection regex), or None when the dir holds no torch checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return None
    best: t.Tuple[int, t.Optional[str]] = (-1, None)
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"model_(\d+)\.pt", name)
        if m and int(m.group(1)) > best[0]:
            best = (int(m.group(1)), os.path.join(ckpt_dir, name))
    return best[1]
