"""Model zoo (counterpart of ``vision_mtl_tpu/models/registry.py``).

Ported so far, at their trained configs (parameters at 19 classes):

  * basic: decoder_first_channel=540, 5 decoder layers, merged heads
    (13,564,301 parameters);
  * mtan: encoder_first_channel=32, 4 encoder levels, hidden=128
    (13,277,908 parameters);
  * csnet: two per-task MobileNetV3-Unets (decoder_first_channel=256, 5
    decoder layers) joined by channel-wise stitch units, diagonal-only
    stitch and zero-pad skip merge (13,382,516 parameters).
"""

from __future__ import annotations

import typing as t

import torch
from torch import nn

from vision_mtl_tpu_torch.cfg import DataConfig
from vision_mtl_tpu_torch.device import resolve_device

#: MTAN's encoder levels at the registry's config
MTAN_LEVELS = 4


def row_stride(model_name: str) -> int:
    """The ``row_stride`` of ``model_name`` as :func:`build_model` builds it:
    its coarsest level has this many times fewer rows than the image
    (``parallel/mesh.check_rows``); 1 for a name the registry does not know."""
    if model_name == "mtan":
        from vision_mtl_tpu_torch.models.mtan import levels_row_stride

        return levels_row_stride(MTAN_LEVELS)
    if model_name in ("basic", "csnet"):
        from vision_mtl_tpu_torch.models.mobilenetv3 import ENCODER_STRIDE

        return ENCODER_STRIDE
    return 1


def build_model(
    model_name: str,
    data_cfg: DataConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: t.Union[str, torch.device] = "cuda",
    seed: int = 0,
    merge_heads: bool = True,
    channel_wise_stitching: bool = True,
    fold_tail: bool = False,
    remat_tail: int = 0,
    remat_encoder: bool = False,
    remat_attention: bool = False,
    remat_shared: bool = False,
    fold_tasks: bool = False,
) -> nn.Module:
    """The named model in eval mode on ``device``, with fresh weights drawn
    from ``seed``; raises if ``device`` is CUDA and no card is present.
    ``train.state.create_train_state`` switches it to train mode.

    ``merge_heads`` (basic) and ``channel_wise_stitching`` (csnet) default
    to the registry's configs; the training CLI passes its flags, as the JAX
    registry reads them from its args (``--channel_wise_stitching`` is off
    unless given, so the CLI trains layer-wise stitching by default). The
    model options go where the JAX registry sends them: ``fold_tail``,
    ``remat_tail`` and ``remat_encoder`` to basic, ``remat_attention``,
    ``remat_shared`` and ``fold_tasks`` to mtan, ``remat_encoder`` and
    ``remat_tail`` to csnet; a model ignores the others."""
    dev = resolve_device(device)
    if model_name == "mtan":
        from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet

        model = MTANMiniUnet(
            map_tasks_to_num_channels={"depth": 1, "segm": data_cfg.num_classes},
            task_subnets_hidden_channels=128,
            encoder_first_channel=32,
            encoder_num_channels=MTAN_LEVELS,
            remat_attention=remat_attention,
            remat_shared=remat_shared,
            fold_tasks=fold_tasks,
            dtype=dtype,
            seed=seed,
        )
        return model.to(dev)
    if model_name == "basic":
        from vision_mtl_tpu_torch.models.basic import BasicMTLModel

        model = BasicMTLModel(
            segm_classes=data_cfg.num_classes,
            decoder_first_channel=540,
            num_decoder_layers=5,
            fold_tail=fold_tail,
            remat_tail=remat_tail,
            remat_encoder=remat_encoder,
            merge_heads=merge_heads,
            dtype=dtype,
            seed=seed,
        )
        return model.to(dev)
    if model_name == "csnet":
        from vision_mtl_tpu_torch.models.cross_stitch import CSNet

        model = CSNet(
            task_channels={"depth": 1, "segm": data_cfg.num_classes},
            decoder_first_channel=256,
            num_decoder_layers=5,
            channel_wise_stitching=channel_wise_stitching,
            remat_encoder=remat_encoder,
            remat_tail=remat_tail,
            dtype=dtype,
            seed=seed,
        )
        return model.to(dev)
    raise NotImplementedError(f"Unknown model name: {model_name}")
