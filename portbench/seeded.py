"""Everything a run draws from its ``--seed``: the weights and the inputs.

Both are made on the run's device by a ``torch.Generator`` seeded with the
run's seed, in a few large calls, so the same seed gives the same numbers
and set-up stays short. The program and the reference are handed the same
tensors.

Weights: one uniform draw on the device for all parameters together, each
parameter's slice scaled to +-1/sqrt(fan in) (torch's default for a conv
and its bias; the attention gate's products likewise over their input
width); BatchNorm scales one, shifts zero, running statistics zero mean
and unit variance.

Inputs: a smooth random field per image (9x9 box smoothing with circular
edges of a normal draw, as the port's synthetic data set makes them),
normalised to [0, 1] and sent as uint8; the mask the argmax of a fixed
random projection of the field's channels; depth ``sigmoid(r - b)`` sent
as uint16. Every seed gives the same shapes and sizes.
"""

from __future__ import annotations

import typing as t

import torch
import torch.nn.functional as F
from torch import nn

from portbench import reference
from portbench.reference.common import F32, Precision, init_bounds

SMOOTH = 9
#: streams of the run's generator: the weights and the inputs draw from
#: different seeds derived from the run's
WEIGHTS, INPUTS = 0, 1


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 2 + stream) % 2**63)


def state_dict(reference: nn.Module, seed: int, device: torch.device) -> t.Dict[str, torch.Tensor]:
    """The weights of a run: ``reference``'s state dict (its module tree
    may sit on the meta device) with every parameter that has an init bound
    drawn from the seed, on ``device``."""
    bounds = init_bounds(reference)
    shapes = {k: v.shape for k, v in reference.state_dict().items()}
    total = sum(shapes[k].numel() for k in bounds)
    flat = torch.rand(total, generator=generator(seed, WEIGHTS, device), device=device)
    flat.mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for key, shape in shapes.items():
        if key in bounds:
            n = shape.numel()
            out[key] = flat[at:at + n].view(shape).mul_(bounds[key])
            at += n
        else:
            fill = 1.0 if key.rsplit(".", 1)[-1] in ONES else 0.0
            out[key] = torch.full(shape, fill, device=device)
    return out


def weights(config: t.Mapping[str, t.Any], seed: int,
            device: torch.device) -> t.Dict[str, torch.Tensor]:
    """The configuration's weights for ``seed``, on ``device``."""
    with torch.device("meta"):
        spec = reference.build(config)
    return state_dict(spec, seed, device)


def reference_model(config: t.Mapping[str, t.Any], seed: int, device: torch.device,
                    precision: Precision = F32) -> nn.Module:
    """The configuration's plain reference on ``device`` with the weights
    for ``seed``."""
    with torch.device(device):
        model = reference.build(config, precision)
    model.load_state_dict(weights(config, seed, device))
    return model


#: the leaves that start at one: BatchNorm scales and running variances
#: (the gate's BNs name theirs scale1/2 and var1/2)
ONES = {"weight", "running_var", "scale1", "scale2", "var1", "var2"}


def _fields(n: int, h: int, w: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """(n, h, w, 3) float32 in [0, 1]."""
    x = torch.randn(n, 3, h, w, generator=gen, device=device)
    pad = SMOOTH // 2
    x = F.avg_pool2d(F.pad(x, (pad, pad, pad, pad), mode="circular"), SMOOTH, stride=1)
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return ((x - lo) / (hi - lo).clamp(min=1e-6)).permute(0, 2, 3, 1)


def train_pool(seed: int, batches: int, batch: int, height: int, width: int, classes: int,
               device: torch.device) -> t.List[t.Dict[str, torch.Tensor]]:
    """``batches`` distinct batches of ``batch`` samples in the wire format
    (uint8 images and masks, uint16 depth (B, H, W, 1)), in pinned host
    memory when ``device`` is a card."""
    gen = generator(seed, INPUTS, device)
    proj = torch.randn(3, classes, generator=gen, device=device)
    pool = []
    for _ in range(batches):
        img = _fields(batch, height, width, gen, device)
        sample = {
            "img": (img * 255.0).round().to(torch.uint8),
            "mask": (img @ proj).argmax(-1).to(torch.uint8),
            "depth": (torch.sigmoid(img[..., :1] - img[..., 2:]) * 65535.0).round()
            .to(torch.int32),
        }
        host = {k: v.cpu() for k, v in sample.items()}
        host["depth"] = host["depth"].to(torch.uint16)  # converted on the host
        pool.append({k: _pin(v) for k, v in host.items()})
    return pool


def frames(seed: int, n: int, height: int, width: int, device: torch.device) -> torch.Tensor:
    """``n`` distinct uint8 (H, W, 3) frames on the host."""
    gen = generator(seed, INPUTS, device)
    return _pin((_fields(n, height, width, gen, device) * 255.0).round().to(torch.uint8).cpu())


def _pin(x: torch.Tensor) -> torch.Tensor:
    return x.pin_memory() if torch.cuda.is_available() else x
