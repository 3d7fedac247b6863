"""Parameter initialization with PyTorch's layer defaults, from an explicit
`torch.Generator` (counterpart of mvae_tpu/nn/initializers.py).

nn.Linear / nn.Conv2d / nn.ConvTranspose2d default to
kaiming_uniform(a=sqrt(5)), which is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
the weight and the same bound for the bias; nn.Embedding to N(0, 1).
Values are drawn on the CPU
and copied to the parameter's device, so one seed gives the same weights
on every device.
"""

import math

import torch


def kaiming_uniform_bound(fan_in: int) -> float:
    return 1.0 / math.sqrt(fan_in)


@torch.no_grad()
def uniform_(tensor, bound: float, generator: torch.Generator):
    """Fill `tensor` in place with U(-bound, bound) drawn from `generator`
    (a CPU generator)."""
    draw = torch.empty(tensor.shape, dtype=torch.float32)
    draw.uniform_(-bound, bound, generator=generator)
    tensor.copy_(draw)
    return tensor


@torch.no_grad()
def normal_(tensor, generator: torch.Generator):
    """Fill `tensor` in place with N(0, 1) drawn from `generator` (a CPU
    generator)."""
    draw = torch.empty(tensor.shape, dtype=torch.float32)
    draw.normal_(generator=generator)
    tensor.copy_(draw)
    return tensor


def init_parameters_(module, generator: torch.Generator):
    """Reset every layer of `module` that has `reset_parameters(generator)`,
    in module order."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module
