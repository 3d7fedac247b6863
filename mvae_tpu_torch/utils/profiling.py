"""Profiler hook (counterpart of mvae_tpu/utils/profiling.py, which writes a
jax.profiler trace).

Pass --profile-dir to the train CLI: the driver traces the second logging
window of the first epoch (the first pays the cuDNN algorithm search and
the kernel build) with torch.profiler and writes a Chrome trace,
`trace.json`, into that directory.

On the card a capture opens with a warm-up (`warm_up`): the profiler drops
the device records of the first kernels a capture launches, none to a few
in a fresh process and more later in its life (14 of a 9846-launch window,
and every record of a 201-launch one; PERF.md, PR 18). The warm-up's
WARM_UP_KERNELS small kernels, under the WARM_UP span, come first and take
that loss; the readers of a capture leave them out (tools/measure.py).
"""

import contextlib
import os
import time

import torch

WARM_UP = "capture warm-up"
WARM_UP_KERNELS = 1024
WARM_UP_PAD_S = 0.05     # host time between the warm-up and the window


def warm_up(device):
    """The warm-up that opens a capture on a CUDA device: WARM_UP_KERNELS
    kernels on one element under the WARM_UP span, synchronized, then
    WARM_UP_PAD_S."""
    with torch.profiler.record_function(WARM_UP):
        x = torch.zeros(1, device=device)
        for _ in range(WARM_UP_KERNELS - 1):
            x.add_(1)
        torch.cuda.synchronize(device)
    time.sleep(WARM_UP_PAD_S)


@contextlib.contextmanager
def maybe_trace(profile_dir, enabled: bool, device):
    """torch.profiler over the block (host and, on a CUDA device, the
    card, after the warm-up), exported to profile_dir/trace.json; a no-op
    when disabled."""
    if not enabled or not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            warm_up(device)
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
