"""Where the port runs: the CUDA card, unless the caller asks for the CPU.

Every entry point (model constructor, weight loader, eval step, Sampler)
takes `device=None` and resolves it here. None means the current CUDA
device, and raises when there is none: the port never drops to the CPU
quietly. `device="cpu"` runs the plain PyTorch versions of the kernels.
"""

import functools

import torch


@functools.cache
def warm_cpu_math():
    """Run PyTorch's CPU exp once on one intra-op thread, then restore the
    thread count. The CPU exp goes through MKL's vector math, whose set-up
    on the first call in a process races when that call runs on several
    threads: on a loaded host the first call can return wrong values, and
    every later call is right (fresh processes, eight at a time on an
    8-core x86 host: the first exp over 24576 elements differed from the
    second by up to 0.32 in 5 of 80 and 6 of 48 processes; after a first
    call on one thread, in none of 96)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        torch.exp(torch.zeros(16))
    finally:
        torch.set_num_threads(threads)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on (see the module docstring); the
    first resolution to the CPU sets up its vector math (warm_cpu_math)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cpu":
        warm_cpu_math()
    return device
