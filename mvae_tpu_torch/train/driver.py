"""Epoch driver (counterpart of mvae_tpu/train/driver.py:38-408, its
single-device path with the dataset resident on the device).

Given a model on the device, the train and test sets, the argparse
namespace of utils/cli.py and the ELBO terms, it runs: the KL-annealed
training epochs in windows of K = --log-interval steps
(`make_multi_train_step`, one loss readback a window), the reference's log
lines, a per-epoch eval of the whole test set, the dual-file `.pth.tar`
checkpoint (train/checkpoint.py) and --resume.

The numbers that decide a run are the JAX package's: the per-epoch
permutation of the training rows comes from
np.random.default_rng(SeedSequence([seed, epoch, 0])) (:249-259), the
ragged tail of an epoch is dropped, and each step's KL weight is
annealing_factor_from_step of its global step in f64, rounded to f32
(:260-268). The reparametrization noise and the dropout masks come from a
torch.Generator on the device, seeded from --seed (a stream apart from the
initial weights'), whose state the checkpoint keeps, so a resumed run
continues bit for bit where the first stopped.

Not ported yet: the mesh, multi-process feeding, tensor parallelism and
host streaming (--no-device-data); utils/cli.py refuses their flags.

`load_model_checkpoint` rebuilds a model from a `.pth.tar`: the entry of
the sample and loglike CLIs.
"""

import time

import numpy as np
import torch

from mvae_tpu_torch.core.anneal import annealing_factor_from_step
from mvae_tpu_torch.data.pipeline import num_batches
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.train import loop as L
from mvae_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from mvae_tpu_torch.utils.profiling import maybe_trace
from mvae_tpu_torch.utils.weights import load_reference_checkpoint


def to_device_data(ds, device):
    """The dataset resident on the device: float images in [0, 1] as uint8
    (round(v * 255), :165-166), decoded inside each step; other arrays as
    they are."""
    out = {}
    for k, v in ds.arrays.items():
        if v.dtype == np.float32 and v.ndim >= 3:
            v = np.round(v * 255.0).astype(np.uint8)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def epoch_windows(seed: int, epoch: int, n: int, batch_size: int, k: int):
    """Yield (first step, idxs (k', batch_size) int64) for each window of an
    epoch over n rows: the steps take consecutive batches of the epoch's
    permutation, k to a window (the last window may be shorter)."""
    perm = np.random.default_rng(
        np.random.SeedSequence([seed, epoch, 0])).permutation(n)
    steps = n // batch_size
    for lo in range(0, steps, k):
        kk = min(k, steps - lo)
        yield lo, perm[lo * batch_size:(lo + kk) * batch_size].reshape(
            kk, batch_size)


def window_betas(epoch: int, lo: int, k: int, n_batches: int,
                 annealing_epochs: int):
    """(k,) f32 KL weights of the window's steps lo .. lo + k - 1."""
    if annealing_epochs <= 0:
        return torch.ones(k)
    steps = torch.arange(k, dtype=torch.float64) + (
        (epoch - 1) * n_batches + lo)
    return annealing_factor_from_step(steps, n_batches,
                                      annealing_epochs).float()


def noise_generator(seed: int, device):
    """The train step's noise generator, on the device, seeded from seed
    through a SeedSequence so that its stream is not the initial weights'
    (those come from a generator seeded with seed itself)."""
    state = np.random.SeedSequence([seed, 1]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def evaluate(eval_step, data, n: int, batch_size: int) -> float:
    """The mean test loss over all n rows of the device-resident `data`:
    the full batches with one loss buffer to read back (as the JAX
    package's make_multi_eval_step, loop.py:215-236), the ragged tail as
    one more batch, each weighted by its rows (:343-373). eval_step:
    make_eval_step(..., device_data=True)."""
    meter = L.AverageMeter()
    dev = next(iter(data.values())).device
    steps = n // batch_size
    if steps:
        idxs = torch.arange(steps * batch_size, device=dev).view(
            steps, batch_size)
        losses = torch.stack([eval_step((data, idx))[0] for idx in idxs])
        for v in losses.tolist():
            meter.update(v, batch_size)
    if n % batch_size:
        tail = torch.arange(steps * batch_size, n, device=dev)
        loss, _ = eval_step((data, tail))
        meter.update(loss.item(), n - steps * batch_size)
    return meter.avg


def run_training(model, train_ds, test_ds, args, term_masks, term_lambdas,
                 *, out_dir, meta, eval_term_lambdas=None, device=None):
    """Train `model` (already on `device`: None is the CUDA card, raises
    without one) for epochs start .. args.epochs; meta: {"model": the
    family, "n_latents"}, written into every checkpoint.
    eval_term_lambdas: the per-epoch eval's weights, where they differ
    from training's (the MNIST families evaluate with 1s, as the
    reference's test() calls its ELBO without weights; driver.py:38-40,
    190-191). Returns the model."""
    device = resolve_device(device)
    seed = args.seed
    generator = noise_generator(seed, device)
    multi_step = L.make_multi_train_step(model, term_masks, term_lambdas,
                                         lr=args.lr, generator=generator,
                                         device=device)
    optimizer = multi_step.optimizer
    start_epoch, best_loss = 1, float("inf")
    if args.resume:
        ckpt = load_checkpoint(args.resume, device=device)
        model.load_state_dict(ckpt["state_dict"], strict=True)
        if {"optimizer", "epoch", "generator"} <= set(ckpt):
            optimizer.load_state_dict(ckpt["optimizer"])
            generator.set_state(ckpt["generator"])
            start_epoch = ckpt["epoch"] + 1
            best_loss = ckpt["best_loss"]
            print(f"resumed from {args.resume} at epoch {ckpt['epoch']}")
        else:
            # a params-only file (the reference's own .pth.tar): warm-start
            # with a fresh optimizer and noise stream from epoch 1
            print(f"warm-started from {args.resume} (params only; "
                  f"fresh optimizer)")

    eval_step = L.make_eval_step(
        model, term_masks,
        term_lambdas if eval_term_lambdas is None else eval_term_lambdas,
        device=device, device_data=True)
    train_dev = to_device_data(train_ds, device)
    test_dev = to_device_data(test_ds, device)
    B, K = args.batch_size, max(1, args.log_interval)
    n_batches = num_batches(len(train_ds), B, True)
    mib = sum(v.numel() * v.element_size() for v in train_dev.values())
    print(f"input pipeline: device-resident ({mib / 2 ** 20:.0f} MiB on "
          f"{device}), {K} steps/dispatch")

    for epoch in range(start_epoch, args.epochs + 1):
        meter = L.AverageMeter()
        epoch_t0 = time.perf_counter()
        n_steps = 0
        for lo, idxs in epoch_windows(seed, epoch, len(train_ds), B, K):
            k = len(idxs)
            betas = window_betas(epoch, lo, k, n_batches,
                                 args.annealing_epochs)
            # --profile-dir: the second window of the first epoch (the
            # first pays the kernel build and cuDNN's algorithm search)
            trace_now = bool(args.profile_dir and epoch == start_epoch
                             and (lo == K or (n_batches <= K and lo == 0)))
            with maybe_trace(args.profile_dir, trace_now, device):
                losses = multi_step(train_dev,
                                    torch.from_numpy(idxs).to(device),
                                    betas.to(device)).tolist()
            for v in losses:                  # one readback a window
                meter.update(v, B)
            n_steps += k
            L.log_train(epoch, lo, B, len(train_ds), n_batches, meter.avg,
                        betas[0].item())
        epoch_dt = time.perf_counter() - epoch_t0
        L.log_epoch(epoch, meter.avg)
        if n_steps > 1 and epoch > start_epoch:   # not the warm-up epoch
            print('====> Throughput: {:.2f} steps/sec'.format(
                n_steps / epoch_dt))

        test_loss = evaluate(eval_step, test_dev, len(test_ds), B)
        L.log_test(test_loss)
        is_best = test_loss < best_loss
        best_loss = min(test_loss, best_loss)
        save_checkpoint(dict(meta, state_dict=model.state_dict(),
                             optimizer=optimizer.state_dict(), epoch=epoch,
                             generator=generator.get_state(),
                             best_loss=float(best_loss),
                             test_loss=float(test_loss)),
                        is_best, out_dir)
    return model


def load_model_checkpoint(path, model_ctor, *, device=None):
    """Rebuild (model, meta) from a `.pth.tar`, the port's own or a
    reference-layout file (driver.py:411-419): model_ctor(meta["n_latents"])
    in f32, as the JAX package builds it, on `device` (None: the CUDA card,
    raises without one), in eval mode, the file's weights loaded with
    strict=True, so a file of another family is refused."""
    device = resolve_device(device)
    sd, meta = load_reference_checkpoint(path, device=device)
    model = model_ctor(meta["n_latents"], device=device)
    model.load_state_dict(sd, strict=True)
    return model, meta
