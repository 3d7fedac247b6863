"""Throughput rows for all six families in one command (counterpart of
scripts/bench_families.py).

    python -m mvae_tpu_torch.tools.bench_families [--k 100]
        [--families mnist,celeba,...] [--bf16] [--flops] [--fast]
        [--seed 0] [--device cpu]

Each family's training step as the JAX script sets it up (family_spec:
its widths, its uint8 data resident on the device, 2000 rows of noise
from --seed (vision 500), masks and lambdas; celeba19's fixed sampled
terms with its recon support, vision's reconstruction masks and B = 50),
run as windows of --k steps of train/loop.py:make_multi_train_step: one
warm-up window, then REPS timed windows, each ending with the host
reading its last loss. Under --bf16 the models compute in bf16 and
celeba19's image BCE takes its bf16 math (the model's bf16_loss, as its
CLI sets it; not with --fast); without --bf16 they run in float32 with
TF32 off, as the train CLIs' --f32. --fast: celeba19's
--fast-term-decode step.

One JSON line a family: ms a step over the windows (median, min, max,
count), steps/s, B, and under --flops the FLOPs a step counted from
shapes (tools/measure.py: flops_per_step), the TFLOP/s sustained and
`mfu`, the share of the card's peak for the step's dtype. Runs on the
CUDA card unless --device says otherwise; on the CPU every device metric
is null.
"""

import argparse
import contextlib
import json
from typing import NamedTuple

import numpy as np
import torch

from mvae_tpu_torch.core.subsets import (
    celeba19_recon_support, celeba19_step_terms)
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models import (
    Celeba19MVAE, CelebaMVAE, FashionMnistMVAE, MnistMVAE, MultiMnistMVAE,
    VisionMVAE)
from mvae_tpu_torch.models.vision import CHANNELS, MODALITIES
from mvae_tpu_torch.tools import measure
from mvae_tpu_torch.train.loop import make_multi_train_step

FAMILY_NAMES = ("mnist", "fashionmnist", "multimnist", "celeba", "celeba19",
                "vision")
N_ROWS = 2000           # each family's resident rows (vision: 500)
N_ATTRS = 18
MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3
LR = 1e-4
BETA = 0.5
REPS = 3                # timed windows after one warm-up window


class Spec(NamedTuple):
    """A family's benchmarked step. data: name -> numpy rows (N, ...) as
    they lie on the device; masks, lambdas: (T, M); dynamic: the step
    takes each step's terms (celeba19, as its driver runs it)."""
    family: str
    model_cls: type
    width: int
    compute_dtype: object
    model_kw: dict
    data: dict
    masks: np.ndarray
    lambdas: np.ndarray
    batch: int
    recon_masks: object
    recon_support: object
    dynamic: bool
    fast: bool
    idxs: np.ndarray     # (k, B): the rows of a window's k steps


def _uint8_images(rng, shape):
    return (rng.random((1,) + shape) * 255).astype(np.uint8)[0]


def _attrs(rng, n):
    return (rng.random((1, n, N_ATTRS)) < 0.3).astype(np.float32)[0]


def family_spec(name, *, bf16=False, fast=False, seed=0, k=1):
    """The family's step as scripts/bench_families.py:30-106 builds it,
    the data drawn from np.random.default_rng(seed) by the same calls in
    the same order (seed 0 gives the JAX script's arrays), then the rows
    of the k steps a window runs."""
    rng = np.random.default_rng(seed)
    cd = torch.bfloat16 if bf16 else None
    n = N_ROWS
    kw, recon_masks, support, dynamic, batch = {}, None, None, False, 100
    masks, lambdas = np.asarray(MASKS), np.asarray(LAMBDAS)
    if name in ("mnist", "fashionmnist"):
        flat = name == "mnist"
        cls = MnistMVAE if flat else FashionMnistMVAE
        width = 64
        if flat:
            cd = cd or torch.float32
        shape = (784,) if flat else (28, 28, 1)
        data = {"image": _uint8_images(rng, (n,) + shape),
                "text": rng.integers(0, 10, (1, n)).astype(np.int32)[0]}
    elif name == "multimnist":
        cls, width = MultiMnistMVAE, 64
        data = {"image": _uint8_images(rng, (n, 50, 50, 1)),
                "text": rng.integers(0, 12, (1, n, 4)).astype(np.int32)[0]}
    elif name == "celeba":
        cls, width = CelebaMVAE, 100
        data = {"image": _uint8_images(rng, (n, 64, 64, 3)),
                "attrs": _attrs(rng, n)}
    elif name == "celeba19":
        cls, width = Celeba19MVAE, 100
        data = {"image": _uint8_images(rng, (n, 64, 64, 3)),
                "attrs": _attrs(rng, n)}
        masks, lambdas = celeba19_step_terms(np.random.default_rng(seed + 1),
                                             1, N_ATTRS, 1.0, 10.0)
        support = celeba19_recon_support(1, N_ATTRS)
        dynamic = True
        kw = {"bf16_loss": bf16 and not fast}
    elif name == "vision":
        cls, width, n, batch = VisionMVAE, 100, 500, 50
        data = {m: _uint8_images(rng, (n, 64, 64, CHANNELS[m]))
                for m in MODALITIES}
        masks = np.concatenate([np.ones((1, 6), np.float32),
                                np.eye(6, dtype=np.float32)])
        lambdas = np.full((7, 6), 1.0 / 6.0, np.float32)
        recon_masks = np.ones((7, 6), np.float32)
    else:
        raise ValueError(f"unknown family {name!r}: one of {FAMILY_NAMES}")
    idxs = rng.integers(0, n, (k, 1, batch))[:, 0]
    return Spec(name, cls, width, cd, kw, data, np.asarray(masks),
                np.asarray(lambdas), batch, recon_masks, support, dynamic,
                fast and name == "celeba19", idxs)


@contextlib.contextmanager
def precision(spec):
    """float32 steps run without TF32 (the train CLIs' --f32); bf16 steps
    with cuDNN's defaults, as the CLIs run them."""
    cudnn = torch.backends.cudnn
    old = cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if spec.compute_dtype != torch.bfloat16:
        cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def build(spec, device, seed=0):
    """The model (weights from seed), the multi-step, the data on the
    device and window(): one window of the spec's k steps, returning the
    (k,) losses on the device."""
    model = spec.model_cls(spec.width, spec.compute_dtype, device=device,
                           generator=torch.Generator().manual_seed(seed),
                           **spec.model_kw)
    fixed = not spec.dynamic
    multi = make_multi_train_step(
        model, spec.masks if fixed else None,
        spec.lambdas if fixed else None, lr=LR, device=device,
        generator=torch.Generator(device=device).manual_seed(seed + 6),
        recon_support=spec.recon_support, fast_skip_decode=spec.fast,
        recon_masks=spec.recon_masks)
    data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in spec.data.items()}
    k = spec.idxs.shape[0]
    idxs = torch.from_numpy(spec.idxs).to(device)
    betas = torch.full((k,), BETA, device=device)
    extra = {}
    if spec.dynamic:
        extra = {name: torch.as_tensor(v, dtype=torch.float32,
                                       device=device).expand(
                     (k,) + v.shape).contiguous()
                 for name, v in (("masks", spec.masks),
                                 ("lambdas", spec.lambdas))}

    def window():
        return multi(data, idxs, betas, **extra)

    return model, window


def step_flops(model, spec):
    return measure.flops_per_step(model, spec.masks, spec.lambdas,
                                  spec.batch, spec.recon_masks)


def bench_family(name, k, device, *, bf16=False, flops=False, fast=False,
                 seed=0, line=None):
    """One family's JSON line (the module docstring)."""
    spec = family_spec(name, bf16=bf16, fast=fast, seed=seed, k=k)
    on_card = measure.on_card(device)
    with precision(spec):
        model, window = build(spec, device, seed)
        measure.window_seconds(window)          # cuDNN's choice, warm-up
        ms = [measure.window_seconds(window) * 1e3 / k for _ in range(REPS)]
    stats = measure.spread(ms)
    steps = 1e3 / stats["median"]
    n_flops = step_flops(model, spec) if flops else None
    tag = ("bf16" if spec.compute_dtype == torch.bfloat16 else "f32") + (
        "+fast" if spec.fast else "")
    out = {"family": name, "precision": tag, "batch": spec.batch, "k": k,
           "ms_per_step": stats, "steps_per_sec": steps,
           "flops_per_step": n_flops,
           "tflops_sustained": (n_flops * steps / 1e12
                                if flops and on_card else None),
           "mfu": (measure.mfu(n_flops, steps, measure.peak_flops(model))
                   if flops and on_card else None),
           "peak": measure.PEAK_SOURCE if flops and on_card else None,
           "bf16_loss": spec.model_kw.get("bf16_loss", False),
           "device": line if line is not None else
           measure.device_line(device), "seed": seed}
    print(json.dumps(out), flush=True)
    return out


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--families", type=str, default=",".join(FAMILY_NAMES))
    ap.add_argument("--bf16", action="store_true",
                    help="compute in bfloat16 (params and losses stay f32)")
    ap.add_argument("--flops", action="store_true",
                    help="also the FLOPs a step from shapes, the TFLOP/s "
                         "sustained and mfu")
    ap.add_argument("--fast", action="store_true",
                    help="celeba19: the --fast-term-decode step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card; 'cpu' for a rehearsal "
                         "(its numbers are not the card's)")
    return ap


def main(argv=None):
    """Prints one JSON line a family; returns them."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    line = measure.device_line(device)
    return [bench_family(name, args.k, device, bf16=args.bf16,
                         flops=args.flops, fast=args.fast, seed=args.seed,
                         line=line)
            for name in args.families.split(",")]


if __name__ == "__main__":
    main()
