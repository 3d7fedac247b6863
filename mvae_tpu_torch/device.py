"""Where the port runs: the CUDA card, unless the caller asks for the CPU.

Every entry point (model constructor, weight loader, eval step, Sampler)
takes `device=None` and resolves it here. None means the current CUDA
device, and raises when there is none: the port never drops to the CPU
quietly. `device="cpu"` runs the plain PyTorch versions of the kernels.
"""

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
