#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (mvae_tpu_torch) runs on one
NVIDIA GPU: builds the CUDA kernels from `mvae_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card, drives the serving
endpoints and the eval-mode ELBO of the shipped CelebA model at full width,
and shows that those paths went through the kernels.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure exits non-zero; nothing is caught):
  1. card, versions, kernel build time
  2. kernels vs their plain versions at the paths' shapes, with times
  3. serving: Sampler on CelebaMVAE(100) in bf16 (every endpoint)
  4. eval step: B=100, T=3, CLI weights, uint8 device-resident data, bf16
     and f32, kernel path and plain versions timed in turns
  5. eval checks: kernel path vs the plain versions (posteriors, loss
     above its ln 2 floor); f32 card vs CPU (posteriors, decoder logits,
     loss above its floor)
  6. the kernels line: launches on phases 3-4, error, times, bounds
Phases 3-4 end with a torch.profiler breakdown of device time per call.
Weights are random from seed 0, the BN statistics and affine parameters
too. The last line is {"ok": true, "device": {...}}.

Times come from CUDA events (kernels) or the host clock around work that
ends in a synchronize (endpoints, steps), on whatever card `nvidia-smi`
names; the bounds use that card's published memory rate and f32 rate.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mvae_tpu_torch import ops
from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.nn.norm import BatchNorm
from mvae_tpu_torch.ops.elbo import bce_rowsum_plain
from mvae_tpu_torch.ops.poe import poe_plain
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.loop import (
    decode_batch, make_eval_step, resolve_decode_dtype)

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

KERNELS = {
    "poe_fwd": dict(route="cuda", source="mvae_tpu_torch/csrc/poe.cu",
                    replaces="mvae_tpu/ops/poe_pallas.py:28"),
    "bce_rowsum_fwd": dict(route="cuda",
                           source="mvae_tpu_torch/csrc/bce_rowsum.cu",
                           replaces="mvae_tpu/ops/elbo_pallas.py:21"),
}


def card_peaks(name):
    """(memory bytes/s, f32 non-tensor FLOP/s): published dense peaks of
    the card, SXM unless the name says otherwise."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12
    if "H100 NVL" in name:
        return 3.9e12, 60e12
    if "H200" in name:
        return 4.8e12, 67e12
    return 3.35e12, 67e12


def device_ms(fn, flush, reps=60):
    """Median device time of fn() in ms: CUDA events around each call, the
    calls queued behind a sleep so the host's launch cost stays out, the
    L2 cache flushed before each call (the path finds its inputs cold)."""
    fn()
    torch.cuda.synchronize()
    events = []
    for i in range(reps):
        if i % 10 == 0:
            torch.cuda._sleep(20_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


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


def bound(nbytes, nops, peaks):
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, nops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev, card, peaks, flush):
    """Each kernel against its plain version at the shapes of the paths."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def report(name, case, got, want, tol, t_k, t_p, t_lib, nbytes, nops,
               main):
        torch.testing.assert_close(got, want, **tol)
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        b_ms, b_by = bound(nbytes, nops, peaks)
        print(f"[kernel] {name} {case}: max_abs_err {err} max_rel_err {rel} "
              f"ms {t_k} plain_ms {t_p} library_ms {t_lib} bound_ms {b_ms} "
              f"({b_by}) | {card}")
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if main:
            row.update(ms=t_k, plain_ms=t_p, library_ms=t_lib, bound_ms=b_ms,
                       bound_by=b_by, case=case)

    d = 100
    for t, b in ((1, 1), (1, 64), (3, 100)):
        mu = torch.randn((2, b, d), generator=g, device=dev)
        lv = torch.randn((2, b, d), generator=g, device=dev)
        masks = torch.tensor(MASKS[:t] if t == 3 else [[1.0, 1.0]],
                             device=dev)
        got = torch.cat(ops.poe_fwd(mu, lv, masks))
        want = torch.cat(poe_plain(mu, lv, masks))
        c, m = b * d, 2
        report("poe_fwd", f"T={t} M=2 B={b} D={d}", got, want, POE_TOL,
               device_ms(lambda: ops.poe_fwd(mu, lv, masks), flush),
               device_ms(lambda: poe_plain(mu, lv, masks), flush), None,
               4 * (2 * m * c + t * m + 2 * t * c),
               c * (4 * m + t * (4 * m + 4)), main=(t == 3))

    f32, bf16 = torch.float32, torch.bfloat16
    for n, nt, k, tdt, main in ((300, 300, 12288, f32, False),
                                (300, 300, 12288, bf16, False),
                                (300, 100, 12288, bf16, True),
                                (300, 300, 18, f32, False),
                                (300, 100, 18, f32, False)):
        x = 3 * torch.randn((n, k), generator=g, device=dev)
        tt = torch.rand((nt, k), generator=g, device=dev).to(tdt)
        got = ops.bce_rowsum_fwd(x, tt)
        want = bce_rowsum_plain(x, tt)
        case = (f"logits ({n},{k}) f32, targets ({nt},{k}) "
                f"{str(tdt).split('.')[-1]}")
        # the library call takes one dtype: its targets are upcast to f32
        # beforehand (twice the bytes of bf16 targets); the nt target rows
        # broadcast over the n // nt terms, as the kernel reads them
        r = n // nt
        x3, t3 = x.view(r, nt, k), tt.float().expand(r, nt, k)
        report("bce_rowsum_fwd", case, got, want, BCE_TOL,
               device_ms(lambda: ops.bce_rowsum_fwd(x, tt), flush),
               device_ms(lambda: bce_rowsum_plain(x, tt), flush),
               device_ms(lambda: F.binary_cross_entropy_with_logits(
                   x3, t3, reduction="none").sum(-1), flush),
               n * k * 4 + nt * k * tt.element_size() + n * 4, 9 * n * k,
               main)
    return rows


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


def eval_data(dev, n_data=1000, batch=100):
    """A uint8 CelebA-shaped dataset resident on the card, and one batch of
    row indices into it."""
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
        mu, lv = model.encode(batch)
        held(f"{dt} B=100 T=3 posteriors, poe_fwd vs plain",
             torch.cat(ops.masked_poe_all_terms(mu, lv, masks)),
             torch.cat(poe_plain(mu, lv, masks)), **POE_TOL)

    gpu = models[torch.float32]
    cpu = celeba(torch.float32, "cpu")
    rows = {k: v[idx[:16]] for k, v in data.items()}
    c_batch = decode_batch({k: v.cpu() for k, v in rows.items()})
    g_batch = decode_batch(rows)
    (c_mu, c_lv), (g_mu, g_lv) = cpu.encode(c_batch), gpu.encode(g_batch)
    held("float32 B=16 encoder mu, card vs CPU", g_mu, c_mu, **CARD_TOL)
    held("float32 B=16 encoder logvar, card vs CPU", g_lv, c_lv, **CARD_TOL)
    pd_mu, pd_lv = ops.masked_poe_all_terms(c_mu, c_lv, masks.cpu())
    z = pd_mu.reshape(-1, pd_mu.shape[-1])
    c_rec, g_rec = cpu.decode(z), gpu.decode(z.to(dev))
    for k in CelebaMVAE.modalities:
        held(f"float32 T*B=48 decoder {k} logits, card vs CPU", g_rec[k],
             c_rec[k], **CARD_TOL)
    _, c_terms = make_eval_step(cpu, MASKS, LAMBDAS, device="cpu")(
        {k: v.cpu() for k, v in rows.items()})
    _, g_terms = make_eval_step(gpu, MASKS, LAMBDAS, device=dev)(rows)
    held("float32 B=16 step loss above floor, card vs CPU",
         loss_above_floor(g_terms), loss_above_floor(c_terms), 1e-4, 0.0)


def profile_breakdown(name, fn, card, reps=5):
    """Device time per call by kernel family (torch.profiler, CUPTI), the
    launches per call, and the device's idle share against the call's
    median wall time without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    wall = host_ms(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    groups = {}
    launches = 0
    for e in prof.key_averages():
        if e.key.startswith("cudaLaunchKernel"):
            launches += e.count
        us = e.self_device_time_total
        if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = e.key
        fam = ("poe_fwd" if "poe_fwd_kernel" in k else
               "bce_rowsum_fwd" if "bce_rowsum_kernel" in k else
               "conv (cuDNN)" if ("xmma" in k and "gemm_" not in k) or
               "cudnn" in k or "conv" in k.lower() else
               "gemm (cuBLAS)" if "gemm" in k.lower() else
               "elementwise / copy" if "elementwise" in k or "copy" in k.lower()
               else "other")
        groups[fam] = groups.get(fam, 0.0) + us / 1e3 / reps
    dev_ms = sum(groups.values())
    parts = ", ".join(f"{k} {v}" for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    print(f"[profile] {name}: wall {wall} ms, device {dev_ms} ms (idle "
          f"share {1 - dev_ms / wall}), {launches / reps} launches per call;"
          f" device ms by family: {parts} | {card}")


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
          f"{peaks[1] / 1e12} f32 TFLOP/s")
    lib = ops.library()
    print(f"[build] kernels built and loaded in {lib.build_seconds} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = phase_kernels(dev, card, peaks, flush)
    del flush

    models = {dt: celeba(dt, dev) for dt in (torch.bfloat16, torch.float32)}
    data, idx = eval_data(dev)
    launches = {}
    for phase, fn in (
            ("serve", lambda: phase_serving(dev, card)),
            ("eval", lambda: phase_eval(dev, card, models, data, idx))):
        ops.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        print(f"[launches] {phase}: {counts}")
        expect(counts["poe_fwd"] > 0, f"{phase} ran no poe_fwd")
        if phase == "eval":
            expect(counts["bce_rowsum_fwd"] > 0, "eval ran no bce_rowsum_fwd")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    phase_eval_checks(dev, models, data, idx)

    line = [{"name": k, **KERNELS[k], "launches": launches[k],
             "max_abs_err": rows[k]["max_abs_err"], "ms": rows[k]["ms"],
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
