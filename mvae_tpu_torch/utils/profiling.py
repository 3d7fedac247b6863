"""The port's profiler spans and its trace hook (counterpart of
mvae_tpu/utils/profiling.py, which writes a jax.profiler trace).

Spans. `span(name)` marks a stage of the train step or of the IWAE
scorer (train/loop.py, core/engine.py, core/loglike.py) as a
torch.profiler range on the profiler's own clock, the clock of the
card's records. It records only while a torch.profiler capture is
running, as torch's own flag says: the train CLI's --profile-dir
(below), the benchmark's traced runs and any `torch.profiler.profile`
see the spans, with no option, flag or variable of the port's. With no
capture running a span costs one flag check and enters a shared no-op
context (an ungated record_function enters the dispatcher each time).

Rules for a span, so that readers of a capture can sort by them:
  - its name starts with SPAN_PREFIX ("mvae.");
  - no name starts with "cu" or "bench." (the benchmark's readers take
    such host events for runtime calls or its own spans) and none holds
    "conv" (a kernel linked to the span would read as a library kernel);
  - a span marks a stage: none sits inside a kernel wrapper, an autograd
    Function or a per-layer module call.
SPANS lists every name the port opens; PERF.md section 3 says which
metric reads each.

Trace hook. Pass --profile-dir to the train CLI: the driver traces the
second logging window of the first epoch (the first pays the cuDNN
algorithm search and the kernel build) with torch.profiler and writes a
Chrome trace, `trace.json`, into that directory; the trace carries the
mvae.* spans.

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
import torch.autograd.profiler as _autograd_profiler

WARM_UP = "capture warm-up"
WARM_UP_KERNELS = 1024
WARM_UP_PAD_S = 0.05     # host time between the warm-up and the window

SPAN_PREFIX = "mvae."
SPANS = (
    "mvae.train.window", "mvae.train.step", "mvae.train.gather",
    "mvae.train.noise", "mvae.train.backward", "mvae.train.allreduce",
    "mvae.train.adam",
    "mvae.engine.elbo", "mvae.engine.encode", "mvae.engine.fuse",
    "mvae.engine.decode.train", "mvae.engine.decode.stats",
    "mvae.engine.loss", "mvae.engine.commit",
    "mvae.score.batch", "mvae.score.encode", "mvae.score.fuse",
    "mvae.score.decode", "mvae.score.weights",
)
_NO_SPAN = contextlib.nullcontext()


def span(name):
    """A torch.profiler range named `name` while a capture is running, else
    a shared no-op context (module docstring)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
