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


def build_model(
    model_name: str,
    data_cfg: DataConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: t.Union[str, torch.device] = "cuda",
    seed: int = 0,
    merge_heads: bool = True,
    channel_wise_stitching: bool = True,
) -> nn.Module:
    """The named model in eval mode on ``device``, with fresh weights drawn
    from ``seed``; raises if ``device`` is CUDA and no card is present.
    ``train.state.create_train_state`` switches it to train mode.

    ``merge_heads`` (basic) and ``channel_wise_stitching`` (csnet) default
    to the registry's configs; the training CLI passes its flags, as the JAX
    registry reads them from its args (``--channel_wise_stitching`` is off
    unless given, so the CLI trains layer-wise stitching by default)."""
    dev = resolve_device(device)
    if model_name == "mtan":
        from vision_mtl_tpu_torch.models.mtan import MTANMiniUnet

        model = MTANMiniUnet(
            map_tasks_to_num_channels={"depth": 1, "segm": data_cfg.num_classes},
            task_subnets_hidden_channels=128,
            encoder_first_channel=32,
            encoder_num_channels=4,
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
            dtype=dtype,
            seed=seed,
        )
        return model.to(dev)
    raise NotImplementedError(f"Unknown model name: {model_name}")
