#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (mvae_tpu_torch) runs on one
NVIDIA GPU: builds the CUDA kernels from `mvae_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card, drives the serving
endpoints, the eval-mode ELBO, the training step and the training CLI of
the shipped CelebA model at full width, and shows that those paths went
through the kernels.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure exits non-zero; nothing is caught):
  1. card, versions, kernel build time
  2. kernels vs their plain versions at the paths' shapes, with times:
     the PoE's forward and backward, the BCE; the four BN passes at each
     of the train step's 11 BN layers; conv2d_moments at the encoder's 3
     BN'd convs, bf16 and f32 (per-step sums too); every kernel launched
     twice gives bit-identical results. Each kernel is timed two ways:
     device_ms (one launch between events, the L2 flushed before it:
     carries the measuring floor of the `[kernel] floor` line) and
     back_to_back_ms (R launches between one pair of events, each on its
     own copy of the inputs: the floor out)
  3. serving: Sampler on CelebaMVAE(100) in bf16 (every endpoint)
  4. eval step: B=100, T=3, CLI weights, uint8 device-resident data, bf16
     and f32, kernel path and plain versions timed in turns
  5. train step: the same setting, Adam(1e-4), windows of K=20 steps of
     make_multi_train_step, kernel path and plain versions in turns (the
     default, unfused encoder route), then the encoder's fused route
     (conv2d_moments, opt-in) and its unfused route in turns, bf16 and
     f32
  6. eval checks: kernel path vs the plain versions (posteriors, loss
     above its ln 2 floor); f32 card vs CPU (posteriors, decoder logits,
     loss above its floor)
  6b. the training CLI: `experiments/celeba/train.py:main` on the
     synthetic CelebA set, CelebaMVAE(100) bf16, 2 epochs on the fused
     route (--conv-moments) into a temporary directory, --resume for a
     third on the default route, then Sampler.from_checkpoint on
     model_best.pth.tar answers one request
  7. train checks: one step on the fused route, kernel path vs plain
     versions (loss, parameter gradients: all eight kernels), bf16 and
     f32; fused vs unfused encoder route
     (loss, gradients, the encoder BNs' running statistics); f32 card vs
     CPU (TF32 off) on one step with the same noise; the loss of the last
     window below the first's; running statistics finite and moved
  8. the kernels line: launches on phases 3-5 and 6b, error, times, bounds
Phases 3-5 end with a torch.profiler breakdown of device time per call.
Weights are random from seed 0, the BN statistics and affine parameters
too. The last line is {"ok": true, "device": {...}}.

Times come from CUDA events (kernels) or the host clock around work that
ends in a synchronize (endpoints, steps, windows), on whatever card
`nvidia-smi` names; the bounds use that card's published memory rate and
its f32 rate, or for the bf16 convolutions its bf16 tensor-core rate.
"""

import contextlib
import copy
import ctypes
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from mvae_tpu_torch import ops
from mvae_tpu_torch.core.engine import multi_term_elbo
from mvae_tpu_torch.experiments.celeba import train as celeba_cli
from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.nn.norm import BatchNorm
from mvae_tpu_torch.ops import bn as bn_ops
from mvae_tpu_torch.ops import convbn
from mvae_tpu_torch.ops.elbo import bce_rowsum_plain
from mvae_tpu_torch.ops.poe import poe_bwd_plain, poe_plain
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.checkpoint import BEST, CKPT
from mvae_tpu_torch.train.loop import (
    decode_batch, draw_noise, make_eval_step, make_multi_train_step,
    resolve_decode_dtype)

MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3        # experiments/celeba/train.py:21
ELEMENTS = (64 * 64 * 3, 18)       # per row: image, attrs (modalities order)
# kernel vs plain on the card: both f32, sums in another order
POE_TOL = dict(rtol=1e-5, atol=1e-6)
BCE_TOL = dict(rtol=1e-5, atol=1e-4)
# eval step's loss above its ln 2 floor, kernel path vs plain versions:
# f32 at the golden tolerance; bf16 decodes through bf16 convolutions,
# where a last-bit change in z can move a rounding, so the bound is looser
STEP_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# f32 card vs CPU (TF32 off): cuDNN/cuBLAS and oneDNN sum in other orders;
# the tolerance of the port's module tests
CARD_TOL = dict(rtol=1e-4, atol=1e-5)

# the train step's BN kernels against their plain versions on the card:
# sums over up to 102400 elements in another order (compared as means,
# so the tolerance is per element); f32 y and dx from the same formula
# with a last-bit difference in exp; in bf16 both round one f32 value, so
# a rare rounding moves by one bf16 step (2^-8 relative, 2^-7 allowed)
BN_SUM_TOL = dict(rtol=1e-5, atol=1e-6)
BN_OUT_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
              torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
# one train step, kernel path vs plain versions: the loss above its ln 2
# floor as in the eval checks; each parameter's gradient in relative
# Frobenius norm: f32 at 1e-4 (the port vs JAX read 5.5e-6 on the CPU);
# bf16 at 5e-2, as a last-bit change before a bf16 rounding flips it and
# the flips propagate (the port vs JAX in bf16 read up to 2e-2 mean
# relative on the CPU); the Linear biases that feed a BN have an exact
# gradient of 0, both sides return rounding noise, held absolutely
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# conv2d_moments against its plain version (cuDNN, TF32 off): f32 y sums
# up to 2048 products in another order; bf16 y rounds an f32 accumulator
# once on both sides, so a rare y sits one bf16 step apart (2^-7
# relative); the sums compared as means over the B*OH*OW pixels, a few
# such steps moving a bf16 mean by far less than 1e-4
CONV_Y_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
              torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
CONV_SUM_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
                torch.bfloat16: dict(rtol=1e-4, atol=1e-4)}
# the encoder BNs' running statistics after one step, fused vs unfused
# route: in f32 the same batch moments from sums in another order; in bf16
# the second and third convs read another input, as the fused route's
# swish rounds in JAX's five bf16 steps and the BN kernel's once from f32
# (a CPU rehearsal at B=100 read 8.4e-5 at most)
EMA_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
           torch.bfloat16: dict(rtol=1e-3, atol=5e-4)}
GRAD_NOISE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# one train step, the encoder's fused route vs its unfused one, at
# GRAD_RTOL: the fused route's BN backward folds y's cotangent with the
# moments' in f32 and rounds once, as the BN kernel's dx does
# (ops/convbn.py)
BATCH, N_DATA = 100, 1000    # rows a step; rows of the resident dataset
TRAIN_K = 20            # steps per window
PROFILE_K = 5           # ... of the windows that run under the profiler
LR = 1e-4               # experiments/celeba/train.py: lr 1e-4

KERNELS = {
    "poe_fwd": dict(route="cuda", source="mvae_tpu_torch/csrc/poe.cu",
                    replaces="mvae_tpu/ops/poe_pallas.py:28"),
    "poe_bwd": dict(route="cuda", source="mvae_tpu_torch/csrc/poe.cu",
                    replaces="mvae_tpu/ops/poe_pallas.py:91 (_bwd, the "
                    "closed-form backward; not a Pallas kernel)"),
    "bce_rowsum_fwd": dict(route="cuda",
                           source="mvae_tpu_torch/csrc/bce_rowsum.cu",
                           replaces="mvae_tpu/ops/elbo_pallas.py:21"),
    "bn_moments": dict(route="cuda", source="mvae_tpu_torch/csrc/bn_swish.cu",
                       replaces="mvae_tpu/ops/bn_pallas.py:92"),
    "bn_normalize": dict(route="cuda",
                         source="mvae_tpu_torch/csrc/bn_swish.cu",
                         replaces="mvae_tpu/ops/bn_pallas.py:102"),
    "bn_bwd_partials": dict(route="cuda",
                            source="mvae_tpu_torch/csrc/bn_swish.cu",
                            replaces="mvae_tpu/ops/bn_pallas.py:107"),
    "bn_dx": dict(route="cuda", source="mvae_tpu_torch/csrc/bn_swish.cu",
                  replaces="mvae_tpu/ops/bn_pallas.py:120"),
    "conv2d_moments": dict(route="cuda",
                           source="mvae_tpu_torch/csrc/conv_moments.cu",
                           replaces="mvae_tpu/ops/convbn_pallas.py:116"),
}
BN_KERNELS = ("bn_moments", "bn_normalize", "bn_bwd_partials", "bn_dx")

# the BN layers of the train step under bf16 compute: (layer, how many
# such layers, G, N, C, S, dtype). G = 3 terms in the decoders. The
# encoder's three conv BNs take the BN kernels only on the unfused route
# (the default); the fused route (conv_moments=True) folds their moments into
# conv2d_moments (ENC_CONV_BN).
BN_LAYERS = (
    ("image enc conv2", 1, 1, 100, 64, 256, torch.bfloat16),
    ("image enc conv3", 1, 1, 100, 128, 64, torch.bfloat16),
    ("image enc conv4", 1, 1, 100, 256, 25, torch.bfloat16),
    ("attrs enc BN1d", 2, 1, 100, 512, 1, torch.float32),
    ("image dec convT1", 1, 3, 100, 128, 64, torch.bfloat16),
    ("image dec convT2", 1, 3, 100, 64, 256, torch.bfloat16),
    ("image dec convT3", 1, 3, 100, 32, 1024, torch.bfloat16),
    ("attrs dec BN1d", 3, 3, 100, 512, 1, torch.float32),
)
BN_MAIN_LAYER = "image dec convT3"      # the largest launch
ENC_CONV_BN = ("image enc conv2", "image enc conv3", "image enc conv4")
# the encoder's BN'd convs at B=100: (layer, B, C_in, H, C_out, stride,
# padding)
CONV_LAYERS = (("image enc conv2", 100, 32, 32, 64, 2, 1),
               ("image enc conv3", 100, 64, 16, 128, 2, 1),
               ("image enc conv4", 100, 128, 8, 256, 1, 0))
CONV_MAIN = ("image enc conv2", torch.bfloat16)
CLI_EPOCHS = 2          # then --resume for one more


def card_peaks(name):
    """(memory bytes/s, f32 non-tensor FLOP/s, bf16 dense tensor-core
    FLOP/s): published peaks of the card, SXM unless the name says
    otherwise."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12, 756e12
    if "H100 NVL" in name:
        return 3.9e12, 60e12, 835e12
    if "H200" in name:
        return 4.8e12, 67e12, 989e12
    return 3.35e12, 67e12, 989e12


def device_ms(fn, flush, reps=60):
    """Median device time of fn() in ms: CUDA events around each call, the
    calls queued behind a sleep so the host's launch cost stays out, the
    L2 cache flushed before each call (the path finds its inputs cold) by
    reading a 256 MB buffer: the cache then holds clean lines, so the timed
    call pays no write-back of an earlier call's (or a zeroing flush's)
    dirty lines."""
    fn()
    torch.cuda.synchronize()
    events = []
    for i in range(reps):
        if i % 10 == 0:
            torch.cuda._sleep(20_000_000)
        flush.max()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


BATCH_BYTES = 100 * 2 ** 20   # back_to_back_ms: the copies, where
BATCH_LAUNCHES = (8, 256)      # ... these launches a batch allow
SLEEP_CYCLES_PER_S = 2e9       # above the card's clock: a sleep long enough


def back_to_back_ms(fn, args, flush, reps=5):
    """Median device time a launch of fn(*args) without the measuring
    floor: R launches back to back between one pair of CUDA events, each
    on its own copy of the tensors in args (outputs kept until the batch
    ends). The L2 is flushed before each batch and each copy is read by
    one launch only, so no launch finds its inputs in L2, whatever R. R
    is the launches whose copies come to BATCH_BYTES (twice the L2), within
    BATCH_LAUNCHES: a small input's batch stops at the upper bound, short
    of BATCH_BYTES. The batch is queued behind a sleep twice as long as the
    host takes to queue it."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if torch.is_tensor(a))
    lo, hi = BATCH_LAUNCHES
    r = min(hi, max(lo, -(-BATCH_BYTES // nbytes)))
    copies = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
              for _ in range(r)]
    keep = [fn(*c) for c in copies]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keep = [fn(*c) for c in copies]
    torch.cuda.synchronize()
    queue_s = time.perf_counter() - t0
    out = []
    for _ in range(reps):
        del keep
        flush.max()
        torch.cuda._sleep(int(2 * queue_s * SLEEP_CYCLES_PER_S))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        keep = [fn(*c) for c in copies]
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / r)
    return statistics.median(out)


def reduction_at(op, geo):
    """bn_moments (op "moments") or bn_bwd_partials ("partials") launched
    through its C entry point at the 6-int geometry geo (csrc/bn_swish.cu:
    reduce_of) in place of the wrapper's: a reading, not the main path (no
    launch count)."""
    lib = ops._cuda.library()
    arr = (ctypes.c_int * 6)(*geo)

    def fn(x4, *rest):
        gsz, _, c, _ = x4.shape
        s = torch.empty((gsz, c), device=x4.device)
        q = torch.empty_like(s)
        st = ops._cuda.stream(x4.device)
        bf16 = int(x4.dtype == torch.bfloat16)
        if op == "moments":
            rc = lib.mvae_bn_moments(x4.data_ptr(), bf16, s.data_ptr(),
                                     q.data_ptr(), *x4.shape, arr, st)
        else:
            g4, a, b = rest
            rc = lib.mvae_bn_bwd_partials(
                x4.data_ptr(), g4.data_ptr(), bf16, a.data_ptr(),
                b.data_ptr(), s.data_ptr(), q.data_ptr(), *x4.shape, arr, st)
        ops._cuda.check(f"bn {op} at {geo}", rc)
        return s, q
    return fn


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


def bound(nbytes, nops, peaks, rate=None):
    """The least ms for nbytes at the memory rate and nops at `rate` (the
    f32 rate unless given)."""
    rate = peaks[1] if rate is None else rate
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, nops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev, card, peaks, flush):
    """Each kernel against its plain version at the shapes of the paths."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def report(name, case, got, want, tol, t_k, t_b2b, t_p, t_lib, nbytes,
               nops, main):
        torch.testing.assert_close(got, want, **tol)
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        b_ms, b_by = bound(nbytes, nops, peaks)
        print(f"[kernel] {name} {case}: max_abs_err {err} max_rel_err {rel} "
              f"ms {t_k} back_to_back_ms {t_b2b} plain_ms {t_p} library_ms "
              f"{t_lib} bound_ms {b_ms} ({b_by}) | {card}")
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if main:
            row.update(ms=t_k, back_to_back_ms=t_b2b, plain_ms=t_p,
                       library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                       case=case)
        return f"{case}: ms {t_k} back_to_back_ms {t_b2b} bound_ms {b_ms}"

    # the PoE's upstream gradients from their own generator, so that the
    # other kernels' inputs stay those of earlier trees
    g_up = torch.Generator(device=dev).manual_seed(7)
    d, m = 100, 2
    for t, b in ((1, 1), (1, 64), (3, 100)):
        mu = torch.randn((m, b, d), generator=g, device=dev)
        lv = torch.randn((m, b, d), generator=g, device=dev)
        masks = torch.tensor(MASKS[:t] if t == 3 else [[1.0, 1.0]],
                             device=dev)
        g_mu, g_lv = torch.randn((2, t, b, d), generator=g_up, device=dev)
        c, case = b * d, f"T={t} M={m} B={b} D={d}"
        # (name, kernel, plain version, inputs, bytes, operations)
        for name, kern, plain, args, nbytes, nops in (
                ("poe_fwd", ops.poe_fwd, poe_plain, (mu, lv, masks),
                 4 * (2 * m * c + t * m + 2 * t * c),
                 c * (4 * m + t * (4 * m + 4))),
                ("poe_bwd", ops.poe_bwd, poe_bwd_plain,
                 (mu, lv, masks, g_mu, g_lv),
                 4 * (4 * m * c + 2 * t * c + t * m),
                 c * (9 * m + t * (9 * m + 6)))):
            got = torch.cat(kern(*args))
            expect(torch.equal(got, torch.cat(kern(*args))),
                   f"{name} {case}: two launches differ")
            report(name, case, got, torch.cat(plain(*args)), POE_TOL,
                   device_ms(lambda: kern(*args), flush),
                   back_to_back_ms(kern, args, flush),
                   device_ms(lambda: plain(*args), flush), None, nbytes,
                   nops, main=(t == 3))

    f32, bf16 = torch.float32, torch.bfloat16
    # (rows, target rows, width, logits dtype, targets dtype, main case):
    # the eval step's image and attribute rows under bf16 compute (f32
    # logits; the main case) and the train step's image rows (bf16 logits)
    bce_main = {}
    for n, nt, k, xdt, tdt, main in ((300, 300, 12288, f32, f32, False),
                                     (300, 300, 12288, f32, bf16, False),
                                     (300, 100, 12288, f32, bf16, "eval"),
                                     (300, 100, 12288, bf16, bf16, "train"),
                                     (300, 300, 18, f32, f32, False),
                                     (300, 100, 18, f32, f32, False)):
        x = (3 * torch.randn((n, k), generator=g, device=dev)).to(xdt)
        tt = torch.rand((nt, k), generator=g, device=dev).to(tdt)
        got = ops.bce_rowsum_fwd(x, tt)
        want = bce_rowsum_plain(x, tt)
        expect(torch.equal(got, ops.bce_rowsum_fwd(x, tt)),
               f"bce_rowsum_fwd ({n},{k}): two launches differ")
        case = (f"logits ({n},{k}) {str(xdt).split('.')[-1]}, targets "
                f"({nt},{k}) {str(tdt).split('.')[-1]}")
        # the library call takes one dtype: bf16 logits and targets are
        # upcast to f32 beforehand (twice their bytes); the nt target rows
        # broadcast over the n // nt terms, as the kernel reads them
        r = n // nt
        x3, t3 = x.float().view(r, nt, k), tt.float().expand(r, nt, k)
        line = report(
            "bce_rowsum_fwd", case, got, want, BCE_TOL,
            device_ms(lambda: ops.bce_rowsum_fwd(x, tt), flush),
            back_to_back_ms(ops.bce_rowsum_fwd, (x, tt), flush),
            device_ms(lambda: bce_rowsum_plain(x, tt), flush),
            device_ms(lambda: F.binary_cross_entropy_with_logits(
                x3, t3, reduction="none").sum(-1), flush),
            n * k * x.element_size() + nt * k * tt.element_size() + n * 4,
            9 * n * k, main == "eval")
        if main:
            bce_main[main] = line
    print(f"[kernel] bce_rowsum_fwd main cases: eval step {bce_main['eval']}"
          f"; train step {bce_main['train']} | {card}")
    return rows


def phase_bn_kernels(dev, card, peaks, flush):
    """The four BN passes against their plain versions at every BN layer
    of the train step, timed both ways, with per-step sums over the 8
    layers of the fused route and the 11 of the unfused one (the default);
    the bf16
    conv layers again in f32 (the --f32 step), checked, not timed. y and
    dx at BN_OUT_TOL, every (G, C) or (C,) output at BN_SUM_TOL (the sums
    as means); each pass launched twice gives bit-identical outputs."""
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {k: {"max_abs_err": 0.0} for k in BN_KERNELS}
    keys = ("ms", "back_to_back_ms", "plain_ms", "library_ms", "bound_ms")
    per_step = {route: {k: dict.fromkeys(keys, 0.0) for k in BN_KERNELS}
                for route in ("fused", "unfused")}
    cases = [layer + (True,) for layer in BN_LAYERS] + [
        (name + " (f32)", n, gg, nn, c, sp, torch.float32, False)
        for name, n, gg, nn, c, sp, dt in BN_LAYERS if dt == torch.bfloat16]
    for layer, count, gsz, n, c, sp, dt, timed in cases:
        x4 = (0.5 + 1.5 * torch.randn((gsz, n, c, sp), generator=g,
                                      device=dev)).to(dt)
        g4 = torch.randn((gsz, n, c, sp), generator=g, device=dev).to(dt)
        scale = 1.0 + 0.2 * torch.randn(c, generator=g, device=dev)
        bias = 0.2 * torch.randn(c, generator=g, device=dev)
        m = n * sp
        s_p, q_p = bn_ops.bn_moments_plain(x4)
        _, mean, _, a, b, invstd = bn_ops.bn_normalize_plain(
            x4, s_p, q_p, m, scale, bias)
        sdz_p, sdzx_p = bn_ops.bn_bwd_partials_plain(x4, g4, a, b)
        numel, isz, gc = x4.numel(), x4.element_size(), gsz * c
        # (name, kernel, plain version, their inputs, the sums' count (a
        # pair of sums, compared as means) or None (an output like x, then
        # (G, C) or (C,) vectors), bytes, operations)
        passes = (
            ("bn_moments", bn_ops.bn_moments, bn_ops.bn_moments_plain,
             (x4,), m, numel * isz + 2 * gc * 4, 3 * numel),
            ("bn_normalize", bn_ops.bn_normalize, bn_ops.bn_normalize_plain,
             (x4, s_p, q_p, m, scale, bias), None,
             2 * numel * isz + 7 * gc * 4 + 2 * c * 4, 8 * numel),
            ("bn_bwd_partials", bn_ops.bn_bwd_partials,
             bn_ops.bn_bwd_partials_plain, (x4, g4, a, b), m,
             2 * numel * isz + 4 * gc * 4, 16 * numel),
            ("bn_dx", bn_ops.bn_dx, bn_ops.bn_dx_plain,
             (x4, g4, sdz_p, sdzx_p, m, a, b, mean, invstd), None,
             3 * numel * isz + 6 * gc * 4 + 2 * c * 4, 18 * numel))
        lib = library_calls(x4, g4, scale, bias) if timed else {}
        case = f"{layer}: x ({gsz}, {n}, {c}, {sp}) {str(dt).split('.')[-1]}"
        for name, kern, plain, args, per, nbytes, nops in passes:
            got, want = kern(*args), plain(*args)
            for one, two in zip(got, kern(*args)):
                expect(torch.equal(one, two),
                       f"{name} {layer}: two launches differ")
            if per:
                pairs = [(torch.stack(got) / per, torch.stack(want) / per,
                          BN_SUM_TOL)]
            else:
                pairs = [(got[0], want[0], BN_OUT_TOL[dt])] + [
                    (k, p, BN_SUM_TOL) for k, p in zip(got[1:], want[1:])]
            err = 0.0
            for k, p, tol in pairs:
                torch.testing.assert_close(k.float(), p.float(), **tol)
                err = max(err, (k.double() - p.double()).abs().max().item())
            row = rows[name]
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if not timed:
                print(f"[kernel] {name} {case}: max_abs_err {err} "
                      f"(checked, not timed)")
                continue
            t_k = device_ms(lambda: kern(*args), flush)
            t_b2b = back_to_back_ms(kern, args, flush)
            t_p = device_ms(lambda: plain(*args), flush)
            t_lib = device_ms(lib[name], flush)
            b_ms, b_by = bound(nbytes, nops, peaks)
            print(f"[kernel] {name} {case}: max_abs_err {err} ms {t_k} "
                  f"back_to_back_ms {t_b2b} plain_ms {t_p} library_ms "
                  f"{t_lib} bound_ms {b_ms} ({b_by}) x{count} per step "
                  f"| {card}")
            for route in per_step:
                if route == "fused" and layer in ENC_CONV_BN:
                    continue
                for key, v in zip(keys, (t_k, t_b2b, t_p, t_lib, b_ms)):
                    per_step[route][name][key] += count * v
            if layer == BN_MAIN_LAYER:
                row.update(ms=t_k, back_to_back_ms=t_b2b, plain_ms=t_p,
                           library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                           case=case)
    for route, layers in (("fused", 8), ("unfused", 11)):
        for name, v in per_step[route].items():
            print(f"[kernel] {name} per train step, {route} route ({layers}"
                  f" layers): " + " ".join(f"{k} {v[k]}" for k in keys)
                  + f" | {card}")
    return rows


def phase_conv_kernels(dev, card, peaks, flush):
    """conv2d_moments against its plain version at the encoder's three BN'd
    convs, bf16 (the CLI's step) and f32 (--f32), timed, with per-step
    sums. The library yardstick is two calls, F.conv2d then torch.var_mean
    of its output: no one PyTorch call computes the conv and its moments."""
    g = torch.Generator(device=dev).manual_seed(2)
    row = {"max_abs_err": 0.0}
    for dt in (torch.bfloat16, torch.float32):
        keys = ("ms", "back_to_back_ms", "plain_ms", "library_ms",
                "bound_ms")
        per_step = dict.fromkeys(keys, 0.0)
        for layer, b, c_in, h, c_out, stride, pad in CONV_LAYERS:
            x = (2 * torch.rand((b, c_in, h, h), generator=g,
                                device=dev)).to(dt)
            w = (torch.randn((c_out, c_in, 4, 4), generator=g, device=dev)
                 / (16 * c_in) ** 0.5).to(dt)
            y, s, q = convbn.conv2d_moments_fwd(x, w, stride, pad)
            for got, want in zip(convbn.conv2d_moments_fwd(x, w, stride, pad),
                                 (y, s, q)):
                expect(torch.equal(got, want), f"conv2d_moments {layer}: two "
                       "launches differ")
            py, ps, pq = convbn.conv2d_moments_plain(x, w, stride, pad)
            torch.testing.assert_close(y.float(), py.float(),
                                       **CONV_Y_TOL[dt])
            pixels = y.numel() // c_out
            got, want = torch.stack((s, q)) / pixels, torch.stack(
                (ps, pq)) / pixels
            torch.testing.assert_close(got, want, **CONV_SUM_TOL[dt])
            err = max((y.double() - py.double()).abs().max().item(),
                      (got.double() - want.double()).abs().max().item())
            row["max_abs_err"] = max(row["max_abs_err"], err)
            t_k = device_ms(lambda: convbn.conv2d_moments_fwd(
                x, w, stride, pad), flush)
            t_b2b = back_to_back_ms(convbn.conv2d_moments_fwd,
                                    (x, w, stride, pad), flush)
            t_p = device_ms(lambda: convbn.conv2d_moments_plain(
                x, w, stride, pad), flush)
            t_lib = device_ms(lambda: torch.var_mean(F.conv2d(
                x, w, stride=stride, padding=pad), dim=(0, 2, 3),
                correction=0), flush)
            isz = x.element_size()
            nbytes = (x.numel() + w.numel() + y.numel()) * isz + 2 * c_out * 4
            nops = 2 * y.numel() * c_in * 16 + 3 * y.numel()
            b_ms, b_by = bound(nbytes, nops, peaks,
                               peaks[2] if dt == torch.bfloat16 else None)
            case = (f"{layer}: x ({b}, {c_in}, {h}, {h}) -> y ({b}, {c_out}"
                    f", {y.shape[2]}, {y.shape[3]}) {str(dt).split('.')[-1]}")
            print(f"[kernel] conv2d_moments {case}: max_abs_err {err} ms "
                  f"{t_k} back_to_back_ms {t_b2b} plain_ms {t_p} library_ms "
                  f"{t_lib} (F.conv2d + "
                  f"torch.var_mean, two calls) bound_ms {b_ms} ({b_by}) | "
                  f"{card}")
            for key, v in zip(keys, (t_k, t_b2b, t_p, t_lib, b_ms)):
                per_step[key] += v
            if (layer, dt) == CONV_MAIN:
                row.update(ms=t_k, back_to_back_ms=t_b2b, plain_ms=t_p,
                           library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                           case=case)
        print(f"[kernel] conv2d_moments per train step, "
              f"{str(dt).split('.')[-1]} (3 layers): "
              + " ".join(f"{k} {per_step[k]}" for k in keys) + f" | {card}")
    return {"conv2d_moments": row}


def library_calls(x4, g4, scale, bias):
    """One PyTorch call (or pair) per BN pass as its yardstick: var_mean
    over (N, S) for the moments; F.batch_norm(training=True) then F.silu,
    per group (two calls a group), for normalize; the autograd backward of
    those calls for both backward passes together."""
    gsz = x4.shape[0]
    xs = [x4[i].detach().clone().requires_grad_(True) for i in range(gsz)]
    w = scale.detach().clone().requires_grad_(True)
    bb = bias.detach().clone().requires_grad_(True)

    def fwd(inputs, weight, b):
        return [F.silu(F.batch_norm(xi, None, None, weight, b, training=True))
                for xi in inputs]

    ys = fwd(xs, w, bb)
    gs = [g4[i] for i in range(gsz)]

    def bwd():
        return torch.autograd.grad(ys, xs + [w, bb], gs, retain_graph=True)

    return {"bn_moments": lambda: torch.var_mean(x4, dim=(1, 3),
                                                 correction=0),
            "bn_normalize": lambda: fwd([x4[i] for i in range(gsz)],
                                        scale, bias),
            "bn_bwd_partials": bwd, "bn_dx": bwd}


def expect(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def check_images(out, n):
    expect(out["image"].shape == (n, 64, 64, 3), f"image {out['image'].shape}")
    expect(out["attrs"].shape == (n, 18), f"attrs {out['attrs'].shape}")
    for k, v in out.items():
        expect(bool(torch.isfinite(v).all()) and v.min() >= 0
               and v.max() <= 1, f"{k} outside [0, 1] or not finite")


def celeba(dtype, dev, seed=0):
    """CelebaMVAE(100) from a seeded generator, with the BN affine
    parameters and running statistics drawn at random too, so eval-mode BN
    does real work (the default init makes it the identity)."""
    model = CelebaMVAE(100, None if dtype == torch.float32 else dtype,
                       device=dev,
                       generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(0.3 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
    return model


def phase_serving(dev, card):
    """Every Sampler endpoint on CelebaMVAE(100) in bf16."""
    sampler = Sampler(celeba(torch.bfloat16, dev), device=dev)
    t0 = time.perf_counter()
    sampler.warmup(buckets=(1, 64))
    torch.cuda.synchronize()
    print(f"[serve] warmup buckets (1, 64): {time.perf_counter() - t0} s"
          f" | {card}")

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((64, 64, 64, 3), np.float32)).to(dev)
    attrs = torch.from_numpy((rng.random((64, 18)) < 0.3)
                             .astype(np.float32)).to(dev)

    out = sampler.sample(n=64, seed=0)
    check_images(out, 64)
    expect(torch.equal(sampler.sample(n=64, seed=0)["image"], out["image"]),
           "prior sampling is not deterministic per seed")
    expect(not torch.equal(sampler.sample(n=64, seed=1)["image"],
                           out["image"]), "two seeds gave one draw")
    cond = sampler.sample(n=3, condition={"attrs": attrs[:1]}, seed=0)
    check_images(cond, 3)
    expect(torch.equal(
        sampler.sample(n=3, condition={"attrs": attrs[:1]}, seed=0)["image"],
        cond["image"]), "conditional sampling is not deterministic per seed")
    for names in (("image",), ("attrs",), ("image", "attrs")):
        inputs = {"image": images, "attrs": attrs}
        inputs = {k: inputs[k] for k in names}
        mu, lv = sampler.embed(inputs)
        expect(mu.shape == lv.shape == (64, 100), f"embed {mu.shape}")
        expect(bool(torch.isfinite(mu).all() and torch.isfinite(lv).all()),
               "embed not finite")
        mu37, _ = sampler.embed({k: v[:37] for k, v in inputs.items()})
        expect(torch.equal(sampler.embed(inputs)[0], mu),
               "embed is not deterministic")
        # 37 rows pad to bucket 64 by repeating row 0; padding never leaks
        torch.testing.assert_close(mu37, mu[:37], rtol=0, atol=0)
    for n in (1, 37, 64):
        rec = sampler.reconstruct({"image": images[:n]})
        check_images(rec, n)

    endpoints = {
        "sample": lambda n: sampler.sample(n=n, seed=0),
        "sample|attrs": lambda n: sampler.sample(
            n=n, condition={"attrs": attrs[:1]}, seed=0),
        "embed|image": lambda n: sampler.embed({"image": images[:n]}),
        "embed|attrs": lambda n: sampler.embed({"attrs": attrs[:n]}),
        "embed|image,attrs": lambda n: sampler.embed(
            {"image": images[:n], "attrs": attrs[:n]}),
        "reconstruct|image": lambda n: sampler.reconstruct(
            {"image": images[:n]}),
    }
    for name, fn in endpoints.items():
        for n in (1, 64):
            print(f"[serve] {name} n={n}: median {host_ms(lambda: fn(n))} ms"
                  f" | {card}")
    profile_breakdown("serve embed|image n=1",
                      lambda: endpoints["embed|image"](1), card)
    profile_breakdown("serve reconstruct|image n=64",
                      lambda: endpoints["reconstruct|image"](64), card)


def eval_data(dev, n_data=None, batch=None):
    """A uint8 CelebA-shaped dataset resident on the card, and one batch of
    row indices into it."""
    n_data, batch = n_data or N_DATA, batch or BATCH
    rng = np.random.default_rng(1)
    data = {"image": torch.from_numpy(rng.integers(
                0, 256, (n_data, 64, 64, 3), dtype=np.uint8)).to(dev),
            "attrs": torch.from_numpy((rng.random((n_data, 18)) < 0.3)
                                      .astype(np.float32)).to(dev)}
    return data, torch.from_numpy(rng.permutation(n_data)[:batch]).to(dev)


def phase_eval(dev, card, models, data, idx):
    """The eval step at full width, bf16 and f32: kernel path and plain
    versions timed in turns, then a device-time breakdown."""
    for dtype, model in models.items():
        step = make_eval_step(model, MASKS, LAMBDAS, device=dev,
                              device_data=True)
        total, per_term = step((data, idx))
        expect(bool(torch.isfinite(per_term).all())
               and per_term.shape == (3,), f"per_term {per_term}")
        dt = str(dtype).split(".")[-1]
        print(f"[eval] {dt} B=100 T=3: total {total.item()} per_term "
              f"{per_term.tolist()}")
        # kernel path and plain versions in turns (K, P, P, K): the host
        # clock of a shared machine drifts
        times = {False: [], True: []}
        for plain in (False, True, True, False):
            with ops.plain_versions() if plain else contextlib.nullcontext():
                times[plain].append(host_ms(lambda: step((data, idx))))
        print(f"[eval] {dt} B=100 T=3 step: median {times[False]} ms "
              f"(plain versions {times[True]} ms) | {card}")
        profile_breakdown(f"eval {dt} B=100 T=3", lambda: step((data, idx)),
                          card)


def train_windows(dev, n_windows):
    """idxs (K, B) of each window on the card: every step a batch of
    distinct rows."""
    rng = np.random.default_rng(3)
    return [torch.from_numpy(np.stack([rng.permutation(N_DATA)[:BATCH]
                                       for _ in range(TRAIN_K)])).to(dev)
            for _ in range(n_windows)]


def running_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def timed_window(multi, data, idxs, betas):
    """(losses of one window, its host ms per step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window_losses = multi(data, idxs, betas)
    torch.cuda.synchronize()
    return window_losses, (time.perf_counter() - t0) * 1e3 / TRAIN_K


def pairs_won(a, b):
    """How the turns of A and B went, pair by pair: the i-th A and the
    i-th B ran next to each other."""
    wins = sum(x < y for x, y in zip(a, b))
    ties = sum(x == y for x, y in zip(a, b))
    return (f"{wins} of {len(a)} pairs to the first, "
            f"{len(a) - wins - ties} to the second, {ties} tied")


def phase_train(dev, card, data, out):
    """The train step at full width, bf16 and f32: windows of K=20 steps
    of make_multi_train_step (one loss readback a window), kernel path
    and plain versions in turns after a warm-up pair, then the encoder's
    fused route (conv2d_moments; opt-in) and its unfused route (the
    default) in turns, each from a copy of the trained model, then a
    device-time breakdown per step of each route (on shorter windows: the
    profiler's own work grows with the events it keeps). Beta 1, as after
    the CLI's 20 annealing epochs. Records each window's mean loss and the
    running statistics before training, for the checks."""
    # a warm-up pair, then K, P, P, K twice (K: kernel path, P: plain);
    # the routes likewise, F, U, U, F four times (F: fused, U: unfused):
    # the default follows them, and the host's noise is large
    order = (False, True) + (False, True, True, False) * 2
    route_order = (False, True) + (False, True, True, False) * 4
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        model = celeba(dtype, dev, seed=10)
        stats0 = running_stats(model)
        multi = make_multi_train_step(
            model, MASKS, LAMBDAS, lr=LR, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        betas = torch.ones(TRAIN_K, device=dev)
        windows = iter(train_windows(dev, len(order) + len(route_order)
                                     + 6))
        losses, times = [], {False: [], True: []}
        for i, plain in enumerate(order):
            with ops.plain_versions() if plain else contextlib.nullcontext():
                window_losses, ms = timed_window(multi, data, next(windows),
                                                 betas)
            losses.append(window_losses.mean().item())
            expect(bool(torch.isfinite(window_losses).all()),
                   f"train {dt}: loss not finite {window_losses}")
            if i >= 2:
                times[plain].append(ms)
        print(f"[train] {dt} B=100 T=3 K={TRAIN_K}: mean loss per window "
              f"{losses} (K, P | K, P, P, K, K, P, P, K)")
        print(f"[train] {dt} B=100 T=3 step: {times[False]} ms (plain "
              f"versions {times[True]} ms), host clock per window / K; "
              f"{pairs_won(times[False], times[True])} | {card}")

        routes = {}
        for fused in (True, False):
            m = copy.deepcopy(model)
            m.image_encoder.features.conv_moments = fused
            routes[fused] = make_multi_train_step(
                m, MASKS, LAMBDAS, lr=LR, device=dev,
                generator=torch.Generator(device=dev).manual_seed(1))
        r_times = {True: [], False: []}
        for i, unfused in enumerate(route_order):
            window_losses, ms = timed_window(routes[not unfused], data,
                                             next(windows), betas)
            expect(bool(torch.isfinite(window_losses).all()),
                   f"train {dt} route: loss not finite {window_losses}")
            if i >= 2:
                r_times[not unfused].append(ms)
        print(f"[train] {dt} B=100 T=3 step, encoder route: fused "
              f"(conv2d_moments) {r_times[True]} ms, unfused {r_times[False]}"
              f" ms, in turns F, U, U, F four times, host clock per window "
              f"/ K; fused against unfused: "
              f"{pairs_won(r_times[True], r_times[False])} | {card}")
        for fused, label in ((True, "fused"), (False, "unfused")):
            profile_breakdown(
                f"train {dt} B=100 T=3 step, {label} encoder route (window "
                f"of {PROFILE_K})",
                lambda: routes[fused](data, next(windows)[:PROFILE_K],
                                      betas[:PROFILE_K]), card,
                reps=1, wall_reps=1, per=PROFILE_K)
        out[dtype] = dict(losses=losses, stats0=stats0, model=model)


# the reference's log lines (train/loop.py:log_train, log_epoch, log_test)
# and the driver's throughput line
LOG_LINE = re.compile(
    r"^(Train Epoch: \d+ \[\d+/\d+ \(\d+%\)\]\tLoss: -?\d+\.\d{6}\t"
    r"Annealing-Factor: \d\.\d{3}|====> Epoch: \d+\tLoss: -?\d+\.\d{4}"
    r"|====> Test Loss: -?\d+\.\d{4}|====> Throughput: \d+\.\d{2} "
    r"steps/sec)$")


class TimedLines(io.TextIOBase):
    """A stdout that passes the text on and keeps each finished line with
    the host time it was finished at."""

    def __init__(self, sink):
        self.sink, self.part, self.lines = sink, "", []

    def write(self, text):
        self.sink.write(text)
        *done, self.part = (self.part + text).split("\n")
        now = time.perf_counter()
        self.lines += [(now, line) for line in done]
        return len(text)

    def flush(self):
        self.sink.flush()


def phase_cli(dev, card):
    """The training CLI on the card: experiments/celeba/train.py:main on
    the synthetic CelebA set (2000 train and 500 val rows, the loader's
    defaults), CelebaMVAE(100) in bf16 (the CLI's defaults), CLI_EPOCHS
    epochs on the fused route (--conv-moments: the path of
    conv2d_moments), annealing 1, windows of 10; then --resume of its
    checkpoint for one more epoch on the default, unfused route; then
    model_best.pth.tar served by Sampler. Checks
    the log lines, the files, the epoch the resume starts at, and a
    finite test loss; prints the throughput and each epoch's wall time."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        out_dir = os.path.join(tmp, "models")
        argv = ["--annealing-epochs", "1", "--log-interval", "10",
                "--out-dir", out_dir, "--data-dir", os.path.join(tmp, "data")]
        rec = TimedLines(sys.stdout)
        with contextlib.redirect_stdout(rec):
            rec.lines.append((time.perf_counter(), "[cli] start"))
            celeba_cli.main(argv + ["--epochs", str(CLI_EPOCHS),
                                    "--conv-moments"])
            rec.lines.append((time.perf_counter(), "[cli] resume"))
            celeba_cli.main(argv + ["--epochs", str(CLI_EPOCHS + 1),
                                    "--resume", os.path.join(out_dir, CKPT)])
        for name in (CKPT, BEST):
            expect(os.path.isfile(os.path.join(out_dir, name)),
                   f"cli: no {name}")
        lines = [line for _, line in rec.lines]
        logs = [line for line in lines if LOG_LINE.match(line)]
        epochs = list(range(1, CLI_EPOCHS + 2))
        for e in epochs:
            expect(sum(line.startswith(f"Train Epoch: {e} [") for line in
                       logs) == 2, f"cli: epoch {e} has not 2 train lines")
            expect(f"====> Epoch: {e}\t" in "\n".join(logs),
                   f"cli: no epoch line for epoch {e}")
        tests = [float(line.split()[-1]) for line in logs
                 if line.startswith("====> Test Loss")]
        expect(len(tests) == len(epochs) and all(np.isfinite(tests)),
               f"cli: test losses {tests}")
        i = lines.index("[cli] resume")
        expect(any(line.startswith("resumed from ") and
                   line.endswith(f"at epoch {CLI_EPOCHS}")
                   for line in lines[i:]), "cli: no resume line")
        first = next(line for line in lines[i:]
                     if line.startswith("Train Epoch"))
        expect(first.startswith(f"Train Epoch: {CLI_EPOCHS + 1} [0/"),
               f"cli: resumed at {first!r}")
        throughput = [line for line in logs if "Throughput" in line]
        expect(len(throughput) == CLI_EPOCHS - 1, "cli: throughput lines")
        # an epoch's training: from the line before its first train line
        # (the pipeline line or the last epoch's test loss) to its epoch line
        train_s, start = [], None
        for t, line in rec.lines:
            if line.startswith(("input pipeline", "====> Test Loss")):
                start = t
            elif line.startswith("====> Epoch"):
                train_s.append(t - start)
        print(f"[cli] CelebaMVAE(100) bf16 B=100, 20 steps an epoch: "
              f"{throughput} ; epoch training wall s {train_s} (epochs "
              f"{epochs}; epoch 1 and the resumed epoch {CLI_EPOCHS + 1} "
              f"include the warm-up) | {card}")

        sampler = Sampler.from_checkpoint(os.path.join(out_dir, BEST),
                                          compute_dtype=torch.bfloat16)
        images = torch.rand((8, 64, 64, 3), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(7))
        check_images(sampler.reconstruct({"image": images}), 8)
        print(f"[cli] {BEST} served one reconstruct request of 8 rows; test "
              f"losses {tests}")


def loss_above_floor(per_term):
    """per_term less its ln 2 floor, the loss of all-zero logits
    (BCE(0, t) = ln 2 for any target), which random weights mostly pay.
    What is left, the fit and the KL, is what a wrong PoE or decode moves."""
    w = torch.tensor(MASKS, dtype=torch.float64) * torch.tensor(
        LAMBDAS, dtype=torch.float64)
    counts = torch.tensor(ELEMENTS, dtype=torch.float64)
    return per_term.double().cpu() - np.log(2.0) * (w @ counts)


def held(what, got, want, rtol, atol):
    """Print the reading, then hold got to want."""
    got, want = got.double().cpu(), want.double().cpu()
    err = (got - want).abs()
    print(f"[check] {what}: max_abs_err {err.max().item()} max_rel_err "
          f"{(err / want.abs().clamp_min(1e-30)).max().item()} "
          f"(rtol {rtol}, atol {atol})")
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@torch.inference_mode()
def phase_eval_checks(dev, models, data, idx):
    """The eval step's parts against references, with BN doing real work:
    the kernel path against the plain versions on the card (posteriors of
    all terms, loss above its ln 2 floor), and in f32 the card against the
    CPU on 16 rows (posteriors, decoder logits, loss above its floor)."""
    masks = torch.tensor(MASKS, device=dev)
    for dtype, model in models.items():
        dt = str(dtype).split(".")[-1]
        step = make_eval_step(model, MASKS, LAMBDAS, device=dev,
                              device_data=True)
        _, per_term = step((data, idx))
        with ops.plain_versions():
            _, p_terms = step((data, idx))
        held(f"{dt} B=100 step loss above floor {loss_above_floor(per_term)}"
             f", kernels vs plain", loss_above_floor(per_term),
             loss_above_floor(p_terms), STEP_RTOL[dtype], 0.0)
        batch = decode_batch({k: v.index_select(0, idx)
                              for k, v in data.items()},
                             resolve_decode_dtype(model))
        mu, lv, _ = model.encode(batch)
        held(f"{dt} B=100 T=3 posteriors, poe_fwd vs plain",
             torch.cat(ops.masked_poe_all_terms(mu, lv, masks)),
             torch.cat(poe_plain(mu, lv, masks)), **POE_TOL)

    gpu = models[torch.float32]
    cpu = celeba(torch.float32, "cpu")
    rows = {k: v[idx[:16]] for k, v in data.items()}
    c_batch = decode_batch({k: v.cpu() for k, v in rows.items()})
    g_batch = decode_batch(rows)
    (c_mu, c_lv, _), (g_mu, g_lv, _) = cpu.encode(c_batch), gpu.encode(g_batch)
    held("float32 B=16 encoder mu, card vs CPU", g_mu, c_mu, **CARD_TOL)
    held("float32 B=16 encoder logvar, card vs CPU", g_lv, c_lv, **CARD_TOL)
    pd_mu, pd_lv = ops.masked_poe_all_terms(c_mu, c_lv, masks.cpu())
    z = pd_mu.reshape(-1, pd_mu.shape[-1])
    (c_rec, _), (g_rec, _) = cpu.decode(z), gpu.decode(z.to(dev))
    for k in CelebaMVAE.modalities:
        held(f"float32 T*B=48 decoder {k} logits, card vs CPU", g_rec[k],
             c_rec[k], **CARD_TOL)
    _, c_terms = make_eval_step(cpu, MASKS, LAMBDAS, device="cpu")(
        {k: v.cpu() for k, v in rows.items()})
    _, g_terms = make_eval_step(gpu, MASKS, LAMBDAS, device=dev)(rows)
    held("float32 B=16 step loss above floor, card vs CPU",
         loss_above_floor(g_terms), loss_above_floor(c_terms), 1e-4, 0.0)


def one_step(model, batch, noise):
    """One train-mode ELBO and its backward, no update: (per_term,
    parameter gradients)."""
    model.train()
    model.zero_grad(set_to_none=True)
    dev = model.device
    total, aux = multi_term_elbo(
        model, batch, torch.tensor(MASKS, device=dev),
        torch.tensor(LAMBDAS, device=dev), 1.0, train=True, noise=noise)
    total.backward()
    return aux["per_term"].detach(), {
        k: p.grad.detach().clone() for k, p in model.named_parameters()}


def bn_fed_biases(model):
    """The Linear biases that feed a BatchNorm: their exact gradient is 0."""
    out = set()
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Sequential):
            for i in range(len(mod) - 1):
                if (isinstance(mod[i + 1], BatchNorm)
                        and getattr(mod[i], "bias", None) is not None):
                    out.add(f"{name}.{i}.bias")
    return out


def grad_gaps(got, want, noisy):
    """(relative Frobenius gap of each gradient not in noisy, largest
    first; the largest absolute gap of those in noisy)."""
    rel, noise = [], 0.0
    for k, w in want.items():
        gap = (got[k].double().cpu() - w.double().cpu()).norm().item()
        if k in noisy:
            noise = max(noise, gap)
        else:
            rel.append((gap / max(w.double().norm().item(), 1e-30), k))
    return sorted(rel, reverse=True), noise


def grads_held(what, got, want, rtol, noise_atol, noisy):
    """Every gradient within rtol of want in relative Frobenius norm, the
    noisy ones (exactly 0 in exact arithmetic) within noise_atol of it."""
    rel, noise = grad_gaps(got, want, noisy)
    print(f"[check] {what}: {len(want)} parameter gradients, largest "
          f"relative gaps {rel[:3]} (rtol {rtol}), BN-fed biases max gap "
          f"{noise} (atol {noise_atol})")
    expect(rel[0][0] < rtol and noise < noise_atol,
           f"{what}: gradients differ")


def encoder_bn_stats(model):
    f = model.image_encoder.features
    return {f"features.{i}.{k}": getattr(f[i], k) for i in (3, 6, 9)
            for k in ("running_mean", "running_var")}


def phase_train_checks(dev, data, idx, trained):
    """One train step on the encoder's fused route, kernel path vs the
    plain versions (loss above its ln 2 floor, every parameter gradient)
    in bf16 and f32; the same step on the unfused route against the fused
    one (loss,
    gradients, the encoder BNs' committed running statistics); f32 card
    vs CPU on 16 rows with the same noise; then, from phase 5, the loss
    falling and the running statistics moved and finite."""
    route_grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        model = celeba(dtype, dev, seed=20)
        model.image_encoder.features.conv_moments = True
        twin = copy.deepcopy(model)
        unfused = copy.deepcopy(model)
        unfused.image_encoder.features.conv_moments = False
        batch = decode_batch({k: v.index_select(0, idx)
                              for k, v in data.items()},
                             resolve_decode_dtype(model))
        noise = draw_noise(model, 3, len(idx), torch.Generator(
            device=dev).manual_seed(5))
        k_terms, k_grads = one_step(model, batch, noise)
        with ops.plain_versions():
            p_terms, p_grads = one_step(twin, batch, noise)
        held(f"{dt} B=100 train step loss above floor, kernels vs plain",
             loss_above_floor(k_terms), loss_above_floor(p_terms),
             STEP_RTOL[dtype], 0.0)
        grads_held(f"{dt} B=100 train step, kernels vs plain", k_grads,
                   p_grads, GRAD_RTOL[dtype], GRAD_NOISE_ATOL[dtype],
                   bn_fed_biases(model))
        counts = ops.launch_counts()
        u_terms, u_grads = one_step(unfused, batch, noise)
        expect(ops.launch_counts()["conv2d_moments"]
               == counts["conv2d_moments"], "the unfused route launched "
               "conv2d_moments")
        held(f"{dt} B=100 train step loss above floor, fused vs unfused "
             f"encoder route", loss_above_floor(k_terms),
             loss_above_floor(u_terms), STEP_RTOL[dtype], 0.0)
        grads_held(f"{dt} B=100 train step, fused vs unfused encoder route",
                   k_grads, u_grads, GRAD_RTOL[dtype],
                   GRAD_NOISE_ATOL[dtype], bn_fed_biases(model))
        u_stats = encoder_bn_stats(unfused)
        for k, v in encoder_bn_stats(model).items():
            held(f"{dt} encoder BN {k} after one step, fused vs unfused",
                 v, u_stats[k], **EMA_TOL[dtype])
        route_grads[dtype] = {"fused": k_grads, "unfused": u_grads}
    # a reading, not a check: how far each bf16 route's gradients lie from
    # the f32 step's on the same weights, batch rows and noise
    want = route_grads[torch.float32]["unfused"]
    for route, grads in route_grads[torch.bfloat16].items():
        rel, _ = grad_gaps(grads, want, bn_fed_biases(model))
        print(f"[reading] bfloat16 B=100 train step, {route} encoder route "
              f"vs the float32 step: largest relative gradient gaps "
              f"{rel[:3]}")

    gpu = celeba(torch.float32, dev, seed=30)
    cpu = celeba(torch.float32, "cpu", seed=30)
    rows = {k: v[idx[:16]] for k, v in data.items()}
    eps, keep = draw_noise(cpu, 3, len(idx[:16]),
                           torch.Generator().manual_seed(6))
    c_terms, c_grads = one_step(cpu, decode_batch(
        {k: v.cpu() for k, v in rows.items()}), (eps, keep))
    g_terms, g_grads = one_step(gpu, decode_batch(rows),
                                (eps.to(dev), keep.to(dev)))
    held("float32 B=16 train step loss above floor, card vs CPU",
         loss_above_floor(g_terms), loss_above_floor(c_terms), 1e-4, 0.0)
    grads_held("float32 B=16 train step, card vs CPU", g_grads, c_grads,
               GRAD_RTOL[torch.float32], GRAD_NOISE_ATOL[torch.float32],
               bn_fed_biases(cpu))

    for dtype, run in trained.items():
        dt = str(dtype).split(".")[-1]
        first, last = run["losses"][0], run["losses"][-1]
        print(f"[check] {dt} train: mean loss of window 1 {first}, of "
              f"window {len(run['losses'])} {last}")
        expect(last < first, f"{dt} train: the loss did not fall")
        now = running_stats(run["model"])
        for k, v in now.items():
            expect(bool(torch.isfinite(v).all()), f"{dt} {k} not finite")
            expect(not torch.equal(v, run["stats0"][k]),
                   f"{dt} {k} did not move")
        print(f"[check] {dt} train: {len(now)} running statistics finite "
              f"and moved")


# kernel families of the profile lines, first match wins
FAMILIES = (
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


def profile_breakdown(name, fn, card, reps=5, wall_reps=20, per=1):
    """Device time per call by kernel family (torch.profiler, CUPTI), the
    launches per call, and the device's idle share against the call's
    median wall time without the profiler; a call of `per` steps is
    reported per step."""
    from torch.profiler import ProfilerActivity, profile
    wall = host_ms(fn, reps=wall_reps) / per
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    groups, other = {}, {}
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
        fam = next((f for f, hit in FAMILIES if hit(e.key)), "other")
        groups[fam] = groups.get(fam, 0.0) + ms
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


_START = time.perf_counter()


def lap(what):
    """Where the run's time goes: seconds since the script started."""
    print(f"[time] {what}: {time.perf_counter() - _START} s since the start")


def run(dev, card, peaks):
    """Phases 2-7; returns the kernel rows of phase 2 and the launches of
    phases 3-5 and 6b."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    # what device_ms reads for a launch with next to no work: every kernel
    # time below carries about this much; back_to_back_ms takes most of it
    # out. bn_bwd_partials' kernel on 2 rows of 8 channels, the rows in
    # one block (a plain launch) or one each in a cluster of 2
    tiny = (torch.zeros((1, 2, 8, 1), device=dev),) * 2 + (
        torch.ones((1, 8), device=dev),) * 2
    for splits, kind in ((1, "a plain launch"), (2, "a cluster of 2")):
        fn = reduction_at("partials", (1, 1, splits, 2 // splits, 256, 8))
        t_one = device_ms(lambda: fn(*tiny), flush)
        t_b2b = back_to_back_ms(fn, tiny, flush)
        print(f"[kernel] floor: bn_bwd_partials on a (1, 2, 8, 1) view "
              f"({kind}) reads {t_one} ms, back_to_back_ms {t_b2b} | {card}")
    rows = phase_kernels(dev, card, peaks, flush)
    rows.update(phase_bn_kernels(dev, card, peaks, flush))
    rows.update(phase_conv_kernels(dev, card, peaks, flush))
    del flush
    lap("kernels against their plain versions")

    models = {dt: celeba(dt, dev) for dt in (torch.bfloat16, torch.float32)}
    data, idx = eval_data(dev)
    trained = {}
    # each path with the counts set to 0 just before it, read just after;
    # the kernels each path must have launched
    must = {"serve": ("poe_fwd",),
            "eval": ("poe_fwd", "bce_rowsum_fwd"),
            "train": tuple(KERNELS), "cli": tuple(KERNELS)}
    launches = {}
    for phase, fn in (
            ("serve", lambda: phase_serving(dev, card)),
            ("eval", lambda: phase_eval(dev, card, models, data, idx)),
            ("train", lambda: phase_train(dev, card, data, trained)),
            ("cli", lambda: phase_cli(dev, card))):
        ops.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        print(f"[launches] {phase}: {counts}")
        lap(phase)
        for k in must[phase]:
            expect(counts[k] > 0, f"{phase} ran no {k}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    phase_eval_checks(dev, models, data, idx)
    phase_train_checks(dev, data, idx, trained)
    lap("checks, the whole run")
    return rows, launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    card = f"{name}, {smi.split(',')[-1].strip()}"
    peaks = card_peaks(name)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; peaks {peaks[0] / 1e12} TB/s, "
          f"{peaks[1] / 1e12} f32 TFLOP/s, {peaks[2] / 1e12} bf16 "
          f"tensor-core TFLOP/s")
    lib = ops.library()
    print(f"[build] kernels built and loaded in {lib.build_seconds} s")
    lap("start and build")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, launches = run(dev, card, peaks)

    line = [{"name": k, **KERNELS[k], "launches": launches[k],
             "max_abs_err": rows[k]["max_abs_err"], "ms": rows[k]["ms"],
             "back_to_back_ms": rows[k]["back_to_back_ms"],
             "plain_ms": rows[k]["plain_ms"], "bound_ms": rows[k]["bound_ms"],
             "bound_by": rows[k]["bound_by"],
             "library_ms": rows[k]["library_ms"]} for k in KERNELS]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
