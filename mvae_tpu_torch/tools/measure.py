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
"""

import statistics
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mvae_tpu_torch.core.engine import decode_plan, static_support

# NVIDIA's H100 SXM data sheet, dense rates at its 700 W limit: bf16 on
# the tensor cores, float32 outside them (TF32 off, as the port's f32
# steps run)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_SOURCE = ("NVIDIA H100 SXM data sheet at 700 W: 989 TFLOP/s dense "
               "bf16, 67 TFLOP/s float32 outside the tensor cores")

# kernel families of the profile lines, first match wins; the port's
# eight kernels under their names in PERF.md
FAMILIES = (
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
    ("conv (cuDNN)", lambda k: ("xmma" in k and "gemm_" not in k)
     or "cudnn" in k or "conv" in k.lower() or "dgrad" in k
     or "wgrad" in k),
    ("gemm (cuBLAS)", lambda k: "gemm" in k.lower()),
    ("reduce", lambda k: "reduce" in k.lower()),
    ("elementwise / copy", lambda k: "elementwise" in k
     or "copy" in k.lower()),
)
PORT_KERNELS = ("poe_fwd", "poe_bwd", "bce_rowsum_fwd", "bn_moments",
                "bn_normalize", "bn_bwd_partials", "bn_dx", "conv2d_moments")


def family_of(kernel: str) -> str:
    return next((f for f, hit in FAMILIES if hit(kernel)), "other")


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
    family, and every kernel's (name, ms, launches a step, family) by
    device time."""
    from torch.profiler import ProfilerActivity, profile
    wall = host_ms(fn, reps=wall_reps) / per if wall_ms is None else wall_ms
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    groups, other, kernels = {}, {}, []
    launches = 0
    for e in prof.key_averages():
        if e.key.startswith("cudaLaunchKernel"):
            launches += e.count
        us = e.self_device_time_total
        # a user annotation (Optimizer.step#Adam.step) spans kernels that
        # are counted on their own
        if (us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        ms = us / 1e3 / reps / per
        fam = family_of(e.key)
        groups[fam] = groups.get(fam, 0.0) + ms
        kernels.append((e.key, ms, e.count / reps / per, fam))
        if fam == "other":
            other[e.key[:70]] = other.get(e.key[:70], 0.0) + ms
    dev_ms = sum(groups.values())
    parts = ", ".join(f"{k} {v}" for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    top = "; ".join(f"{k} {v}" for k, v in
                    sorted(other.items(), key=lambda kv: -kv[1])[:4])
    what = "per step" if per > 1 else "per call"
    print(f"[profile] {name}: wall {wall} ms, device {dev_ms} ms (idle "
          f"share {1 - dev_ms / wall}), {launches / reps / per} launches "
          f"{what}; device ms by family: {parts}; largest in other: {top} "
          f"| {card}")
    if host_top:
        host = sorted(((e.self_cpu_time_total / 1e3 / reps / per, e.key,
                        e.count / reps / per) for e in prof.key_averages()
                       if e.self_cpu_time_total > 0), reverse=True)
        print(f"[profile] {name}: host self ms {what} (calls) of the top "
              f"{host_top} ops: " + "; ".join(
                  f"{k} {ms} ({n})" for ms, k, n in host[:host_top]))
    return {"wall_ms": wall, "device_ms": dev_ms,
            "idle_share": 1 - dev_ms / wall,
            "launches": launches / reps / per, "families": groups,
            "kernels": sorted(kernels, key=lambda k: -k[1])}


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
