"""The traced run's capture and its reduction to records (the benchmark's
frozen copy of the port's profile arithmetic, tools/measure.py:
profile_records, family_of, records_lost, kept_capture, and
utils/profiling.py:warm_up).

A capture is one torch.profiler run (host and CUDA activities) over the
traced windows. It opens with a warm-up of WARM_UP_KERNELS one-element
kernels under the WARM_UP span: the card's profiler drops the records of
the first kernels a capture launches, and the warm-up takes that loss;
its launches and their records are left out. A capture that still lost
more than LOST_MAX kernel records is made again, up to CAPTURES times.

Each device record is linked to the aten op whose launch it is, by the
correlation id its launch shares with it; library kernels (convolutions,
matrix products) are told by that op, the port's own kernels by their
names, and each launch of a port kernel is matched to the span the
benchmark opened around the call into the port's op (port_calls.py) by
the host time of its launch.
"""

import re
import time

import torch

WARM_UP = "capture warm-up"
WARM_UP_KERNELS = 1024
WARM_UP_PAD_S = 0.05
WINDOW = "bench.traced_window"
LAUNCH = re.compile(r"cu(da)?Launch(Cooperative)?Kernel")
NOT_KERNELS = ("Memset", "Memcpy")
LOST_MAX = 8
CAPTURES = 4

# the port's kernels by name (the frozen list of tools/measure.py:
# PORT_KERNELS and their name rules)
PORT_KERNELS = (
    ("poe_fwd", lambda k: "poe_fwd_kernel" in k),
    ("poe_bwd", lambda k: "poe_bwd_kernel" in k),
    ("bce_rowsum_fwd", lambda k: "bce_rowsum_kernel" in k),
    ("bn_moments", lambda k: "bn_reduce_kernel" in k and "MomentsOp" in k),
    ("bn_normalize", lambda k: "bn_normalize_kernel" in k),
    ("bn_bwd_partials", lambda k: "bn_reduce_kernel" in k
     and "PartialsOp" in k),
    ("bn_dx", lambda k: "bn_dx_kernel" in k),
    ("conv2d_moments", lambda k: "conv_moments" in k),
)
GEMM_OPS = frozenset(f"aten::{op}" for op in (
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "_addmm_activation",
    "matmul", "linear", "mv", "addmv", "dot"))


def port_kernel(name):
    """The port kernel a device record's name is, or None."""
    return next((k for k, hit in PORT_KERNELS if hit(name)), None)


def is_library(name, op):
    """A kernel launched by an aten convolution or matrix-product op; where
    no op is linked, a cuDNN or cuBLAS kernel by its name."""
    if op:
        if re.search(r"convolution|conv\dd|conv_transpose", op) or \
                op in GEMM_OPS:
            return True
    low = name.lower()
    return (any(s in low for s in ("cudnn", "cublas", "gemm", "conv"))
            or any(s in name for s in ("fprop", "dgrad", "wgrad"))
            or name.startswith("nvjet"))


def warm_up(device):
    """The capture's opening warm-up (module docstring)."""
    with torch.profiler.record_function(WARM_UP):
        x = torch.zeros(1, device=device)
        for _ in range(WARM_UP_KERNELS - 1):
            x.add_(1)
        torch.cuda.synchronize(device)
    time.sleep(WARM_UP_PAD_S)


class Event:
    __slots__ = ("name", "start", "end", "corr", "linked", "device",
                 "annotation")

    def __init__(self, k):
        self.name = k.name()
        self.start = k.start_ns()
        self.end = self.start + k.duration_ns()
        self.corr = k.correlation_id()
        self.linked = k.linked_correlation_id()
        self.device = k.device_type() == torch.autograd.DeviceType.CUDA
        # a span copied onto the device's timeline, not an operation
        self.annotation = self.device and k.is_user_annotation()


def reduce_events(events, span_prefix):
    """The records of one capture (a list of Event): kernels and copies on
    the device, each with its op, port kernel and port span; the host's
    kernel launches; the traced window's span; the warm-up left out."""
    cpu = [e for e in events if not e.device]
    warm = [(e.start, e.end) for e in cpu if e.name == WARM_UP]
    gone = {e.corr for e in cpu if LAUNCH.match(e.name)
            and any(a <= e.start <= b for a, b in warm)}
    window = next(((e.start, e.end) for e in cpu if e.name == WINDOW), None)
    ops = {}
    for e in cpu:
        if e.linked == 0 and (e.name.startswith("aten::")
                              or e.corr not in ops):
            ops[e.corr] = e.name
    launches = {e.corr: e for e in cpu
                if LAUNCH.match(e.name) and e.corr not in gone}
    spans = sorted((e.start, e.end, int(e.name[len(span_prefix):]))
                   for e in cpu if e.name.startswith(span_prefix))
    records = []
    for e in events:
        if (not e.device or e.annotation or e.end <= e.start
                or e.corr in gone):
            continue
        port = port_kernel(e.name)
        call = None
        if port is not None and e.corr in launches:
            t = launches[e.corr].start
            call = next((i for a, b, i in spans if a <= t <= b), None)
        op = ops.get(e.linked)
        records.append({"name": e.name, "op": op, "start": e.start,
                        "end": e.end, "us": (e.end - e.start) / 1e3,
                        "port": port, "call": call,
                        "library": port is None and is_library(e.name, op)})
    kernels = sum(not r["name"].startswith(NOT_KERNELS) for r in records)
    lost = max(0, len(launches) - kernels)
    host = [e for e in cpu if e.corr not in gone and e.end > e.start
            and e.name not in (WINDOW, WARM_UP)
            and not e.name.startswith(span_prefix)
            and not LAUNCH.match(e.name) and not e.name.startswith("cu")]
    return {"records": records, "launched": len(launches), "lost": lost,
            "window": window, "host": host}


def capture(fn, device, span_prefix, log):
    """fn() under torch.profiler, opened by the warm-up, kept or retaken
    by the records-lost rule; returns reduce_events' result. On the CPU
    (the tests) the host alone is traced and no record is kept."""
    from torch.profiler import ProfilerActivity, profile
    card = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card
                                           else [])
    for n in range(1, CAPTURES + 1):
        with profile(activities=activities) as prof:
            if card:
                warm_up(device)
            with torch.profiler.record_function(WINDOW):
                fn()
                if card:
                    torch.cuda.synchronize(device)
        events = [Event(k) for k in prof.profiler.kineto_results.events()]
        out = reduce_events(events, span_prefix)
        log(f"records_lost {out['lost']} of {out['launched']} kernel "
            f"launches (capture {n} of at most {CAPTURES})")
        if out["lost"] <= LOST_MAX and out["window"] is not None:
            return out
    raise RuntimeError(f"each of {CAPTURES} captures lost more than "
                       f"{LOST_MAX} kernel records")


def busy_intervals(records, window):
    """The union of the device records' intervals inside the window, as
    sorted (start, end) ns."""
    lo, hi = window
    spans = sorted((max(r["start"], lo), min(r["end"], hi))
                   for r in records if r["end"] > lo and r["start"] < hi)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_gaps(busy, window, host, top=10):
    """The device's idle time inside the window by what the host was
    doing at each gap's middle (the innermost host op running then, on
    any thread): the `top` largest sums, [name, seconds]."""
    lo, hi = window
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host = sorted(host, key=lambda e: e.start)
    starts = [e.start for e in host]
    import bisect
    sums = {}
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        # the latest-starting op that still runs at mid (look back a while)
        name = "no host op"
        for e in reversed(host[max(0, i - 512):i]):
            if e.end >= mid:
                name = e.name
                break
        sums[name] = sums.get(name, 0.0) + (b - a) / 1e9
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:top]]


def device_ops(records, top=10):
    """The device operations that took the most time: [name, seconds]."""
    sums = {}
    for r in records:
        sums[r["name"]] = sums.get(r["name"], 0.0) + r["us"] / 1e6
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:top]]
