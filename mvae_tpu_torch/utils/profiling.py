"""Profiler hook (counterpart of mvae_tpu/utils/profiling.py, which writes a
jax.profiler trace).

Pass --profile-dir to the train CLI: the driver traces the second logging
window of the first epoch (the first pays the cuDNN algorithm search and
the kernel build) with torch.profiler and writes a Chrome trace,
`trace.json`, into that directory.
"""

import contextlib
import os

import torch


@contextlib.contextmanager
def maybe_trace(profile_dir, enabled: bool, device):
    """torch.profiler over the block (host and, on a CUDA device, the
    card), exported to profile_dir/trace.json; a no-op when disabled."""
    if not enabled or not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
