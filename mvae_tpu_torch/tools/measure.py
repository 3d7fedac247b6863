"""What the port's measuring tools share (tools/bench.py, bench_families.py,
roofline_family.py, serve_latency.py, and chip_smoke.py at the root): the
card's line, the published peaks, host timing of windows that end in a
synchronize, the torch.profiler breakdown of a call by kernel family, peak
device memory, and the training step's FLOPs counted from shapes, whose
share of the peak is `mfu`.

    mfu = flops_per_step * steps/s / peak

flops_per_step counts the convolutions and matrix products that the
multi-term ELBO step needs, 2 FLOPs a multiply-add as XLA's cost analysis
counts them: each modality's encoder once; each term's decode only for
the modalities whose loss weight in that term is non-zero; in the
backward the gradient of every operand that needs one (every trained
weight, and an activation wherever a layer upstream of it trains).
Elementwise work, the BN and loss kernels and the optimizer are not
counted.

What the port's step runs beyond that is counted apart
(dead_decode_flops): on the grouped decode (core/engine.py:decode_plan),
the forward of a BN'd decoder for the terms that never train it (its
batch statistics), and the decodes of terms whose static support holds a
modality their step's weights leave at 0 (celeba19's sampled terms), with
their backward; on the one-batch decode (a step without a plan), every
term's decode of a modality at a loss weight of 0, with its backward.
Stateless decoders of terms that never train them run nothing.

The shapes are read off one forward of the model's encode and decode at
the step's batch, in eval mode with autograd on (the same convolutions
and products as the train step), by a dispatch mode that records each
product's FLOPs, which of its operands need a gradient, and which of the
model's top-level modules ran it.

The step's bytes (count_step_bytes) are computed from shapes too, on one
step at the step's shapes, no timing in them: bytes_ops, every op of the
step reading each tensor input once and writing each output once (the
counterpart of XLA's "bytes accessed", an upper bound on the traffic; a
kernel of the port is one op with its wrapper's inputs and outputs), and
bytes_floor, what any implementation of the step must move (the batch's
rows, the parameters, gradients and Adam's moments, the BN running
statistics, and each tensor autograd saves for the backward, written
once and read once). Their time at the card's memory rate against the
FLOPs' at its peak is the step's bound.
"""

import contextlib
import copy
import json
import re
import statistics
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from mvae_tpu_torch.core.engine import decode_plan, static_support
from mvae_tpu_torch.ops import _cuda
from mvae_tpu_torch.utils.profiling import WARM_UP, warm_up

# NVIDIA's H100 SXM data sheet, dense rates at its 700 W limit: bf16 on
# the tensor cores, float32 outside them (TF32 off, as the port's f32
# steps run)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_SOURCE = ("NVIDIA H100 SXM data sheet at 700 W: 989 TFLOP/s dense "
               "bf16, 67 TFLOP/s float32 outside the tensor cores")

# the memory rate of the same data sheet: HBM3 on the SXM card
HBM_BYTES_PER_S = 3.35e12
HBM_SOURCE = "NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3"

# kernel families of the profile lines, first match wins: the port's
# eight kernels (under their names in PERF.md), NCCL and Adam by the
# kernel's name; then a library kernel by the aten op that launched it,
# where the profiler links the launch to an op (OP_FAMILIES), else by its
# name (NAME_FAMILIES). cuDNN's forward kernels are named
# sm90_xmma_fprop_implicit_gemm_...: their name holds "gemm_" but
# neither "conv" nor "cudnn"
KERNEL_FAMILIES = (
    ("all-reduce (NCCL)", lambda k: "nccl" in k.lower()),
    ("poe_fwd", lambda k: "poe_fwd_kernel" in k),
    ("poe_bwd", lambda k: "poe_bwd_kernel" in k),
    ("bce_rowsum_fwd", lambda k: "bce_rowsum_kernel" in k),
    ("bn_moments", lambda k: "bn_reduce_kernel" in k and "MomentsOp" in k),
    ("bn_normalize", lambda k: "bn_normalize_kernel" in k),
    ("bn_bwd_partials", lambda k: "bn_reduce_kernel" in k
     and "PartialsOp" in k),
    ("bn_dx", lambda k: "bn_dx_kernel" in k),
    ("conv2d_moments", lambda k: "conv_moments" in k),
    ("adam (foreach)", lambda k: "multi_tensor_apply" in k),
)
CONV = "conv (cuDNN)"
GEMM = "gemm (cuBLAS)"
GEMM_OPS = frozenset(f"aten::{op}" for op in (
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "_addmm_activation",
    "matmul", "linear", "mv", "addmv", "dot"))
OP_FAMILIES = (
    (CONV, lambda op: re.search(r"convolution|conv\dd|conv_transpose",
                                op) is not None),
    (GEMM, lambda op: op in GEMM_OPS),
)
NAME_FAMILIES = (
    (CONV, lambda k: "cudnn" in k.lower() or "conv" in k.lower()
     or any(s in k for s in ("fprop", "dgrad", "wgrad", "implicit_gemm"))),
    (GEMM, lambda k: "gemm" in k.lower() or "cublas" in k.lower()
     or k.startswith("nvjet")),
    ("reduce", lambda k: "reduce" in k.lower()),
    ("elementwise / copy", lambda k: "elementwise" in k
     or "copy" in k.lower()),
)
PORT_KERNELS = ("poe_fwd", "poe_bwd", "bce_rowsum_fwd", "bn_moments",
                "bn_normalize", "bn_bwd_partials", "bn_dx", "conv2d_moments")


def family_of(kernel: str, op=None) -> str:
    """The family of a kernel launched by the aten op `op` (None where no
    op is linked to the launch)."""
    for rules, key in ((KERNEL_FAMILIES, kernel),
                       (OP_FAMILIES if op else (), op),
                       (NAME_FAMILIES, kernel)):
        fam = next((f for f, hit in rules if hit(key)), None)
        if fam is not None:
            return fam
    return "other"


def smi_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def device_line(device):
    """What a tool's JSON line says of where it ran: "cpu", or the card's
    name (torch), power limit (nvidia-smi) and the device count."""
    if not on_card(device):
        return "cpu"
    smi = smi_line()
    return {"name": torch.cuda.get_device_name(device),
            "power_limit": smi.split(",")[-1].strip(), "smi": smi,
            "count": torch.cuda.device_count()}


def card_text(line) -> str:
    """The device line as the profile lines end: "name, power limit"."""
    return line if isinstance(line, str) else line["smi"]


def sync(device):
    if on_card(device):
        torch.cuda.synchronize(device)


def host_ms(fn, reps=20):
    """Median wall time of fn() + synchronize, in ms."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def window_seconds(window):
    """Host seconds of window(), a call that returns a (K,) loss tensor on
    the device, fenced by the host reading its last loss."""
    t0 = time.perf_counter()
    losses = window()
    last = float(losses[-1])
    dt = time.perf_counter() - t0
    if not np.isfinite(last):
        raise RuntimeError(f"the window's last loss is {last}")
    return dt


def spread(values) -> dict:
    return {"count": len(values), "median": statistics.median(values),
            "min": min(values), "max": max(values)}


def peak_memory_bytes(fn, device) -> int:
    """The most device memory allocated while fn() runs, what was already
    allocated included: reset_peak_memory_stats, then
    max_memory_allocated."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device)


def breakdown(records, calls):
    """Device time of kernel records (name, the aten op that launched it
    or None, us) over `calls` steps or calls: ms by family, every
    kernel's (name, ms, launches, family) by device time, and every
    (kernel, op) pair's row with its family by the op and by the name
    alone (`launchers`), each a step or call."""
    groups, rows = {}, {}
    for kernel, op, us in records:
        row = rows.setdefault((kernel, op), [0.0, 0])
        row[0] += us / 1e3 / calls
        row[1] += 1
    kernels, launchers = {}, []
    for (kernel, op), (ms, n) in rows.items():
        fam = family_of(kernel, op)
        groups[fam] = groups.get(fam, 0.0) + ms
        k = kernels.setdefault((kernel, fam), [0.0, 0])
        k[0] += ms
        k[1] += n
        launchers.append({"kernel": kernel, "op": op, "family": fam,
                          "by_name": family_of(kernel), "ms": ms,
                          "launches": n / calls})
    kernels = sorted(((name, ms, n / calls, fam)
                      for (name, fam), (ms, n) in kernels.items()),
                     key=lambda k: -k[1])
    return groups, kernels, sorted(launchers, key=lambda r: -r["ms"])


# Each kernel the host launches (LAUNCH: through the runtime or the
# driver) should have its device record; memsets and copies have records
# and no such launch. The card's profiler drops the records of the first
# kernels a capture launches (utils/profiling.py): a capture opens with a
# warm-up whose launches and records are left out, one that lost more
# than LOST_MAX records all the same is made again, up to CAPTURES times,
# and the records lost are reported.
LAUNCH = re.compile(r"cu(da)?Launch(Cooperative)?Kernel")
NOT_KERNELS = ("Memset", "Memcpy")
LOST_MAX = 8
CAPTURES = 4


def profile_records(prof):
    """The device events of a torch.profiler run as breakdown's records,
    each with the op its launch is linked to, the host's kernel launches
    through the runtime, and its kernel launches through the runtime or
    the driver, read off the profiler's raw events (a device event's
    linked correlation id is its op's; where an op of the frontend shares
    its id with another host event, the aten op is taken). A user
    annotation (Optimizer.step#Adam.step) spans kernels that are counted
    on their own. The warm-up's launches and their records are left
    out."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    spans = [(k.start_ns(), k.start_ns() + k.duration_ns()) for k in events
             if k.device_type() == cpu and k.name() == WARM_UP]
    warm = {k.correlation_id() for k in events
            if k.device_type() == cpu and LAUNCH.match(k.name())
            and any(a <= k.start_ns() <= b for a, b in spans)}
    events = [k for k in events if k.correlation_id() not in warm
              or (k.device_type() == cpu and not LAUNCH.match(k.name()))]
    ops = {}
    for k in events:
        if k.device_type() == cpu and k.linked_correlation_id() == 0:
            name = k.name()
            if name.startswith("aten::") or k.correlation_id() not in ops:
                ops[k.correlation_id()] = name
    records, launches, launched = [], 0, 0
    for k in events:
        if k.device_type() == cpu:
            launches += k.name().startswith("cudaLaunchKernel")
            launched += LAUNCH.match(k.name()) is not None
        elif (k.device_type() == cuda and k.duration_ns() > 0
              and not k.is_user_annotation()):
            records.append((k.name(), ops.get(k.linked_correlation_id()),
                            k.duration_ns() / 1e3))
    return records, launches, launched


def records_lost(records, launched) -> int:
    """The kernel launches (through the runtime or the driver) that have
    no kernel among breakdown's records."""
    return max(0, launched - sum(not r[0].startswith(NOT_KERNELS)
                                 for r in records))


def kept_capture(name, capture):
    """capture() -> (result, records, launched), called until it lost at
    most LOST_MAX records, at most CAPTURES times; that capture's
    (result, records, records lost)."""
    for n in range(1, CAPTURES + 1):
        result, records, launched = capture()
        lost = records_lost(records, launched)
        if lost <= LOST_MAX:
            return result, records, lost
        print(f"[profile] {name}: capture {n} of {CAPTURES} lost {lost} of "
              f"{launched} kernel records")
    raise RuntimeError(f"profile {name}: each of {CAPTURES} captures lost "
                       f"more than {LOST_MAX} kernel records")


def host_ops(prof):
    """The host's ops of a torch.profiler run by name: {name: [self us,
    calls]}, the warm-up's left out."""
    events = prof.events()
    spans = [e.time_range for e in events if e.name == WARM_UP]
    ops = {}
    for e in events:
        if not any(s.start <= e.time_range.start <= s.end for s in spans):
            op = ops.setdefault(e.key, [0.0, 0])
            op[0] += e.self_cpu_time_total
            op[1] += 1
    return ops


def profile_breakdown(name, fn, card, reps=5, wall_reps=20, per=1,
                      host_top=0, wall_ms=None, trace_path=None):
    """Device time per call by kernel family (torch.profiler, CUPTI), the
    launches per call, and the device's idle share against the call's
    median wall time without the profiler (wall_reps calls of fn; or
    wall_ms, a wall time per step measured by the caller); a call of
    `per` steps is reported per step. host_top: also the ops of most host
    self time (under the profiler, which adds its own). trace_path: the
    Chrome trace is written there. Prints the profile line and returns
    its numbers: wall_ms, device_ms, idle_share and launches a step, ms by
    family, every kernel's (name, ms, launches a step, family) by device
    time, and breakdown's launchers."""
    from torch.profiler import ProfilerActivity, profile
    wall = host_ms(fn, reps=wall_reps) / per if wall_ms is None else wall_ms

    def capture():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            warm_up(torch.cuda.current_device())
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        records, launches, launched = profile_records(prof)
        return (prof, launches), records, launched

    (prof, launches), records, lost = kept_capture(name, capture)
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    groups, kernels, launchers = breakdown(records, reps * per)
    other = {}
    for kernel, ms, _, fam in kernels:
        if fam == "other":
            other[kernel[:70]] = other.get(kernel[:70], 0.0) + ms
    dev_ms = sum(groups.values())
    parts = ", ".join(f"{k} {v}" for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    top = "; ".join(f"{k} {v}" for k, v in
                    sorted(other.items(), key=lambda kv: -kv[1])[:4])
    what = "per step" if per > 1 else "per call"
    print(f"[profile] {name}: wall {wall} ms, device {dev_ms} ms (idle "
          f"share {1 - dev_ms / wall}), {launches / reps / per} launches "
          f"{what}; device ms by family: {parts}; largest in other: {top}; "
          f"kernel records lost {lost} | {card}")
    moved = [r for r in launchers if r["family"] != r["by_name"]
             and not r["kernel"].startswith(("Memset", "Memcpy"))]
    if moved:
        print(f"[profile] {name}: kernels whose op sets a family other than "
              f"their name's, by device ms {what}: " + "; ".join(
                  f"{r['kernel'][:90]} under {r['op']}: {r['family']}, by "
                  f"name {r['by_name']}, {r['ms']}" for r in moved[:3]))
    if host_top:
        host = sorted(((us / 1e3 / reps / per, key, n / reps / per)
                       for key, (us, n) in host_ops(prof).items() if us > 0),
                      reverse=True)
        print(f"[profile] {name}: host self ms {what} (calls) of the top "
              f"{host_top} ops: " + "; ".join(
                  f"{k} {ms} ({n})" for ms, k, n in host[:host_top]))
    return {"wall_ms": wall, "device_ms": dev_ms,
            "idle_share": 1 - dev_ms / wall,
            "launches": launches / reps / per, "records_lost": lost,
            "families": groups,
            "kernels": kernels, "launchers": launchers}


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the host's and the card's work: the wall span of a trace leaves out the
# profiler's own events
WORK_CATS = DEVICE_CATS + ("cpu_op", "user_annotation", "cuda_runtime",
                           "cuda_driver")


def trace_records(trace):
    """A Chrome trace of torch.profiler (export_chrome_trace; a path or the
    parsed object): its device events as breakdown's records, each linked
    by its "External id" to the aten op that launched it; the host's
    kernel launches through the runtime, and through the runtime or the
    driver; the wall span of its host and device work in us; and
    the train steps it holds (Adam's Optimizer.step annotations). The
    warm-up (utils/profiling.py) is left out: its span, its launches and
    their records."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == WARM_UP]
    warm = {id(e): e for e in events if e.get("cat") not in DEVICE_CATS
            and any(a <= e["ts"] <= b for a, b in spans)}
    gone = {e.get("args", {}).get("correlation") for e in warm.values()
            if e.get("cat") in LAUNCH_CATS}
    events = [e for e in events if id(e) not in warm
              and not (e.get("cat") in DEVICE_CATS
                       and e.get("args", {}).get("correlation") in gone)]
    op_of = {e["args"]["External id"]: e["name"] for e in events
             if e.get("cat") == "cpu_op"
             and "External id" in e.get("args", {})}
    records = [(e["name"], op_of.get(e.get("args", {}).get("External id")),
                float(e.get("dur", 0))) for e in events
               if e.get("cat") in DEVICE_CATS and e.get("dur", 0) > 0]
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                   and e["name"].startswith("cudaLaunchKernel"))
    launched = sum(1 for e in events if e.get("cat") in LAUNCH_CATS
                   and LAUNCH.match(e["name"]) is not None)
    steps = sum(1 for e in events if e.get("cat") == "user_annotation"
                and e["name"].startswith("Optimizer.step#"))
    work = [e for e in events if e.get("cat") in WORK_CATS]
    wall = (max(e["ts"] + e.get("dur", 0) for e in work)
            - min(e["ts"] for e in work)) if work else 0.0
    return records, launches, launched, wall, steps


# --------------------------------------------------------------------------
# FLOPs from shapes
# --------------------------------------------------------------------------

aten = torch.ops.aten


def _mm(args, out):
    a, b = args[0], args[1]
    return 2 * a.shape[0] * a.shape[1] * b.shape[1], (a, b)


def _addmm(args, out):
    return _mm(args[1:], out)


def _bmm(args, out):
    a, b = args[0], args[1]
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2], (a, b)


def _baddbmm(args, out):
    return _bmm(args[1:], out)


def _convolution(args, out):
    """A convolution's multiply-adds are a weight element's at each output
    position; a transposed one's at each input position."""
    x, w, transposed = args[0], args[1], args[6]
    where = x.shape[2:] if transposed else out.shape[2:]
    return 2 * x.shape[0] * int(np.prod(where)) * w.numel(), (x, w)


_PRODUCTS = {aten.mm: _mm, aten.addmm: _addmm, aten.bmm: _bmm,
             aten.baddbmm: _baddbmm, aten.convolution: _convolution}


class _ProductRecorder(TorchDispatchMode):
    """Each product's FLOPs, (forward, the backward it needs: the same
    count again for every operand that needs a gradient), summed by the
    top-level module that ran it (`owner`, None outside one)."""

    def __init__(self):
        super().__init__()
        self.owner = None
        self.flops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rule = _PRODUCTS.get(func.overloadpacket)
        if rule is not None:
            n, operands = rule(args, out)
            grads = sum(bool(t.requires_grad) for t in operands)
            f, b = self.flops.get(self.owner, (0, 0))
            self.flops[self.owner] = (f + n, b + n * grads)
        return out


def _recorded(model, fn):
    """(forward, backward) FLOPs of fn() by the model's top-level module
    that ran them."""
    rec = _ProductRecorder()
    hooks = []
    for name, child in model.named_children():
        hooks.append(child.register_forward_pre_hook(
            lambda m, a, name=name: setattr(rec, "owner", name)))
        hooks.append(child.register_forward_hook(
            lambda m, a, o: setattr(rec, "owner", None)))
    try:
        with torch.enable_grad(), rec:
            fn()
    finally:
        for h in hooks:
            h.remove()
    return rec.flops


class StepFlops(NamedTuple):
    needed: int         # flops_per_step
    dead: int           # what the port's step runs beyond it
    encode: int
    decode: dict        # modality -> one term's decode at the batch,
                        # forward and backward
    forward: dict       # modality -> its forward alone


def count_step(model, masks, lambdas, batch: int, recon_masks=None,
               recon_support=None, fast_skip_decode=False):
    """The multi-term ELBO train step's FLOPs from shapes at `batch` rows
    (the module docstring): masks, lambdas, recon_masks (T, M) as the
    step takes them; recon_support, fast_skip_decode as
    train/loop.py:make_train_step takes them (None: the static support
    of masks and lambdas, the step's own for static masks; a step with
    per-call terms and no support, one-batch, passes all ones). A model
    whose decoders run several modalities in one product (vision's
    --stack-modalities) is refused."""
    if getattr(model, "stack_modalities", False):
        raise ValueError("flops_per_step counts a decoder a modality; "
                         "stack_modalities runs three in one product")
    was_training = model.training
    model.eval()
    dev = model.device
    spec = model.input_spec()
    inputs = {k: torch.zeros((batch,) + tuple(shape), dtype=dtype,
                             device=dev) for k, (shape, dtype) in spec.items()}
    z = torch.zeros((batch, model.n_latents), device=dev, requires_grad=True)
    try:
        enc = _recorded(model, lambda: model.encode(inputs))
        dec_by = _recorded(model, lambda: model.decode(z))
    finally:
        model.train(was_training)
    mods = model.modalities
    fwd, bwd = ({m: 0 for m in mods} for _ in range(2))
    loose = (0, 0)
    for owner, (f, b) in dec_by.items():
        m = (owner[:-len("_decoder")] if owner is not None
             and owner.endswith("_decoder") else None)
        if m in fwd:
            fwd[m] += f
            bwd[m] += b
        else:
            loose = (loose[0] + f, loose[1] + b)
    # decoders that are no top-level module of their own (celeba19's
    # stacked attribute experts, alike in shape) share what ran outside one
    own = [m for m in mods if not hasattr(model, f"{m}_decoder")]
    if any(loose):
        if not own or loose[0] % len(own) or loose[1] % len(own):
            raise ValueError(f"{loose} decode FLOPs of no modality")
        for m in own:
            fwd[m] += loose[0] // len(own)
            bwd[m] += loose[1] // len(own)
    dec = {m: fwd[m] + bwd[m] for m in mods}
    rmask = np.asarray(masks if recon_masks is None else recon_masks,
                       np.float64)
    weight = rmask * np.asarray(lambdas, np.float64)
    live = (weight != 0).sum(axis=0)
    terms = weight.shape[0]
    encode = sum(f + b for f, b in enc.values())
    needed = encode + sum(int(live[i]) * dec[m] for i, m in enumerate(mods))
    runs = sum(terms * dec[m] for m in mods)
    if recon_support is None:
        recon_support = static_support(masks, lambdas, recon_masks)
    plan = decode_plan(model, recon_support,
                       fast_skip_decode=fast_skip_decode, device=dev)
    if plan is not None:
        runs = 0
        for group in plan:
            names = mods[group.columns[0]:group.columns[1]]
            for call in group.calls:
                one = dec if call.grad else fwd
                if call.operand is None:
                    runs += len(call.index) * sum(one[m] for m in names)
                else:                       # the experts it gathers
                    runs += len(call.operand.experts) * one[names[0]]
    return StepFlops(needed, encode + runs - needed, encode, dec, fwd)


def flops_per_step(model, masks, lambdas, batch: int, recon_masks=None):
    """The FLOPs one train step needs (count_step's `needed`)."""
    return count_step(model, masks, lambdas, batch, recon_masks).needed


def dead_decode_flops(model, masks, lambdas, batch: int, recon_masks=None,
                      recon_support=None, fast_skip_decode=False):
    """What the port's train step runs beyond flops_per_step (count_step's
    `dead`, the module docstring)."""
    return count_step(model, masks, lambdas, batch, recon_masks,
                      recon_support, fast_skip_decode).dead


def peak_flops(model) -> float:
    """The peak of the step's compute dtype (bf16 or float32)."""
    dtype = getattr(model, "compute_dtype", None)
    return PEAK_FLOPS[torch.bfloat16 if dtype == torch.bfloat16
                      else torch.float32]


def mfu(flops: int, steps_per_s: float, peak: float) -> float:
    """The whole step's share of the card's peak."""
    return flops * steps_per_s / peak


# --------------------------------------------------------------------------
# bytes from shapes
# --------------------------------------------------------------------------

# ops that move no bytes: allocations (their outputs are written by the
# ops that fill them)
_NO_BYTES = (aten.empty, aten.empty_like, aten.empty_strided,
             aten.new_empty, aten.new_empty_strided)
# gathers read the rows they write, not the whole of their source
_GATHERS = (aten.index_select, aten.index, aten.gather, aten.embedding)


def nbytes(tree) -> int:
    """The bytes of every tensor in a nest of arguments or outputs."""
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _storages(tree):
    return [t.untyped_storage().data_ptr() for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


class _ByteCounter(TorchDispatchMode):
    """Each op's tensor inputs read once and outputs written once; a view
    moves nothing. A call marked ops/_cuda.py:one_op is one op with its
    arguments and results, the ops inside it uncounted. `weights`: the
    storages of the parameters and of what ops make from them alone (a
    bf16 copy, a stack of experts' weights)."""

    def __init__(self, params):
        super().__init__()
        self.depth = 0
        self.bytes = 0
        self.ops = 0
        self.params = set(_storages(params))
        self.weights = set(self.params)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if not func.is_view:
            ins = _storages((args, kwargs))
            made = set(_storages(out)) - self.params
            if ins and all(p in self.weights for p in ins):
                self.weights |= made
            else:
                self.weights -= made
        if self.depth or func.is_view or packet in _NO_BYTES:
            return out
        written = nbytes(out)
        read = (written + nbytes((args[1:], kwargs)) if packet in _GATHERS
                else nbytes((args, kwargs)))
        self.bytes += read + written
        self.ops += 1
        return out

    @contextlib.contextmanager
    def one_op(self, name, args):
        outer = self.depth == 0
        self.depth += 1
        out = []

        def done(result):
            out.append(result)
            return result

        try:
            yield done
        finally:
            self.depth -= 1
        if outer and out:
            self.bytes += nbytes(args) + nbytes(out[0])
            self.ops += 1


class StepBytes(NamedTuple):
    ops: int            # bytes_ops
    floor: int          # bytes_floor, the sum of parts
    parts: dict         # bytes_floor by what moves
    n_ops: int          # the ops bytes_ops counts
    saved_weights: int  # saved copies of the weights (not in the floor)


def count_step_bytes(model, masks, lambdas, data, batch: int, *,
                     recon_support=None, fast_skip_decode=False,
                     recon_masks=None, seed=0):
    """The train step's bytes (the module docstring) on a copy of model:
    make_train_step(..., device_data=True) over `data` (name -> the
    resident rows on the model's device), the first `batch` rows, beta
    0.5, noise from seed; the first step warms Adam's state, the second
    is counted. Adam runs foreach, as the card's default, so the CPU
    counts the card's ops.

    bytes_floor's parts: "batch", the batch's rows as they lie resident,
    read once by the gather; "params", read in the forward and again in
    the backward, and written by Adam; "grads", written, then read by
    Adam; "adam", its two moments read and written; "bn_stats", the
    running statistics read and written by the commit; "saved", each
    tensor autograd saves for the backward (once, whatever saves it),
    written once and read once; the weights and what is made from them
    alone (the bf16 copies a layer saves) are left to "params", and
    their saved copies' bytes are reported apart (saved_weights). A step
    with per-call terms passes one step's as masks and lambdas, with its
    recon_support."""
    from mvae_tpu_torch.train.loop import make_train_step
    model = copy.deepcopy(model)
    dev = model.device
    step = make_train_step(
        model, masks, lambdas, lr=1e-4, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed),
        device_data=True, recon_support=recon_support,
        fast_skip_decode=fast_skip_decode, recon_masks=recon_masks)
    for group in step.optimizer.param_groups:
        group["foreach"] = True
    idx = torch.arange(batch, device=dev)
    step((data, idx), 0.5)
    params = list(model.parameters())
    counter = _ByteCounter(params)
    saved = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        key = (ptr, t.storage_offset(), t.numel(), t.dtype)
        saved[key] = (t.numel() * t.element_size(), ptr in counter.weights)
        return t

    with _cuda.counting(counter), counter, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        step((data, idx), 0.5)
        sync(dev)
    p = sum(t.numel() * t.element_size() for t in params)
    stats = sum(b.numel() * b.element_size() for b in model.buffers()
                if b.is_floating_point())
    parts = {"batch": sum(v[:batch].numel() * v.element_size()
                          for v in data.values()),
             "params": 3 * p, "grads": 2 * p, "adam": 4 * p,
             "bn_stats": 2 * stats,
             "saved": 2 * sum(n for n, w in saved.values() if not w)}
    return StepBytes(counter.bytes, sum(parts.values()), parts,
                     counter.ops,
                     2 * sum(n for n, w in saved.values() if w))


def step_bound(flops: int, bytes_floor: int, peak: float) -> dict:
    """The step's bound: the larger of its FLOPs at the peak and its
    bytes_floor at the memory rate, in ms, and which of the two sets
    it."""
    compute = flops / peak * 1e3
    memory = bytes_floor / HBM_BYTES_PER_S * 1e3
    return {"compute_ms": compute, "memory_ms": memory,
            "bound_ms": max(compute, memory),
            "bound_by": "operations" if compute >= memory else "bytes"}
