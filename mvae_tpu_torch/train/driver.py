"""Epoch driver (counterpart of mvae_tpu/train/driver.py:38-408).

Given a model on the device, the train and test sets, the argparse
namespace of utils/cli.py and the ELBO terms, it runs: the KL-annealed
training epochs, the reference's log lines, a per-epoch eval of the whole
test set, an optional post-epoch hook (vision's reconstruction grids), the
dual-file `.pth.tar` checkpoint (train/checkpoint.py) and --resume.

Two input pipelines, chosen as the JAX package chooses (:152-186): the
dataset resident on the device while its reckoned bytes (float images as
uint8) stay under DEVICE_DATA_BUDGET, in windows of K = --log-interval
steps (`make_multi_train_step`, one loss readback a window); otherwise,
or with --no-device-data, host streaming (:294-326): each step's rows,
as host floats, are copied to the device, one loss readback a log line.

The numbers that decide a run are the JAX package's. Resident: the
per-epoch permutation of the training rows comes from
np.random.default_rng(SeedSequence([seed, epoch, 0])) (:249-259), and
each step's KL weight is annealing_factor_from_step of its global step in
f64, rounded to f32 (:260-268). Host streaming: data/pipeline.py:batches'
order (SeedSequence([seed, epoch]), a shuffle) and the step-wise
annealing_factor. Both drop an epoch's ragged tail. The resident path
stores float images as round(v * 255) uint8 and so trains on quantised
values; host streaming trains on the floats, as in the JAX package
(:165-166). The reparametrization noise and the dropout masks come from a
torch.Generator on the device, seeded from --seed (a stream apart from
the initial weights'), whose state the checkpoint keeps, so a resumed run
continues bit for bit where the first stopped. A family with sampled ELBO
terms (celeba19, `make_masks`) draws each step's (T, M) masks and lambdas
on the host from np.random.default_rng(seed + 1), as the JAX package does
(:221, 269-272); the checkpoint keeps that Generator's state too, so a
resume continues its sequence (the JAX package restarts it).

Data parallelism across processes (the JAX package's mesh and
multi-process branches, :53-142, 161-186, 223-259, 344-394): with
--coordinator host:port --process-id i --n-processes N, or --distributed
under torchrun, `parallel/distributed.py:maybe_initialize` starts the
process group before anything touches the model, and N ranks train one
model on global batches of B rows, B / N a rank (the train step's dp,
train/loop.py: BN statistics shared, gradients averaged; one device's
values on the whole batch). A batch that N does not divide is refused
(parallel/mesh.py: the JAX package's tensor-parallel factor is not
ported). Rank 0's initial weights are broadcast to the others. Resident:
each rank keeps its 1/N block of the train and test sets after dropping
len % N rows, the budget applies to a shard, and rank r permutes its
block's rows with SeedSequence([seed, epoch, r]) (with N = 1, the
single-device order above). Host streaming: every rank iterates the same
global batches and keeps its rows (distributed.local_rows). The logged
loss is averaged across the ranks once a window (resident) or a log line
(streaming). Eval: each rank evaluates its rows, rank 0 also the len % N
rows no shard holds (streaming: the ragged last batch), and the test loss
is the rows-weighted mean over all ranks, one device's. Only rank 0 logs
and writes the checkpoints; post_epoch runs on every rank and gates its
own file writes (distributed.is_coordinator). --resume: every rank reads
the same file.

Not ported yet: tensor and expert parallelism (the JAX mesh's "model"
axis) and serving over a data-parallel group.

`load_model_checkpoint` rebuilds a model from a `.pth.tar`: the entry of
the sample and loglike CLIs.
"""

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from mvae_tpu_torch.core.anneal import (
    annealing_factor, annealing_factor_from_step)
from mvae_tpu_torch.data.pipeline import batches, num_batches
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.parallel.collectives import sum_in_place
from mvae_tpu_torch.parallel.distributed import (
    local_rows, maybe_initialize, process_rows)
from mvae_tpu_torch.parallel.mesh import data_parallel
from mvae_tpu_torch.train import loop as L
from mvae_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from mvae_tpu_torch.utils.profiling import maybe_trace
from mvae_tpu_torch.utils.weights import load_reference_checkpoint

# The resident path's limit on the train and test sets' reckoned bytes
# (JAX's `< 6 * 2**30`, :183-186), set there for a 16 GB TPU chip. What
# the H100's 80 GB should hold is a question for measurement (ROADMAP).
DEVICE_DATA_BUDGET = 6 * 2 ** 30


def _is_image(v):
    return v.dtype == np.float32 and v.ndim >= 3


def reckoned_bytes(ds):
    """The bytes the dataset takes resident: float images as uint8."""
    return sum(v.nbytes // (4 if _is_image(v) else 1)
               for v in ds.arrays.values())


def to_device_data(ds, device, rows=None):
    """The dataset resident on the device: float images in [0, 1] as uint8
    (round(v * 255), :165-166), decoded inside each step; other arrays as
    they are. rows: a slice of the rows to keep (a rank's shard), or
    None for all."""
    out = {}
    for k, v in ds.arrays.items():
        if rows is not None:
            v = v[rows]
        if _is_image(v):
            v = np.round(v * 255.0).astype(np.uint8)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def shard_rows(n: int, rank: int, world: int) -> slice:
    """Rank's block of a set of n rows kept resident: the first
    n - n % world rows split into world equal blocks (:161-181)."""
    return slice(*process_rows(n - n % world, rank, world))


def to_device_batch(batch, device):
    """A host batch (name -> numpy rows) copied to the device as it is."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def epoch_windows(seed: int, epoch: int, n: int, batch_size: int, k: int,
                  rank: int = 0):
    """Yield (first step, idxs (k', batch_size) int64) for each window of an
    epoch over n rows (rank's shard under data parallelism, batch_size
    its rows a step): the steps take consecutive batches of the epoch's
    permutation of SeedSequence([seed, epoch, rank]), k to a window (the
    last window may be shorter)."""
    perm = np.random.default_rng(
        np.random.SeedSequence([seed, epoch, rank])).permutation(n)
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


def _sums(losses, rows):
    """(the rows-weighted sum, the rows) of a list of 0-d loss tensors,
    one readback."""
    meter = L.AverageMeter()
    for v, n in zip(torch.stack(losses).tolist() if losses else [], rows):
        meter.update(v, n)
    return meter.sum, meter.count


def eval_sums(eval_step, data, n: int, batch_size: int) -> tuple:
    """(the rows-weighted sum of the test losses, the rows) over all n
    rows of the device-resident `data`: the full batches with one loss
    buffer to read back (as the JAX package's make_multi_eval_step,
    loop.py:215-236), the ragged tail as one more batch (:343-373).
    eval_step: make_eval_step(..., device_data=True)."""
    dev = next(iter(data.values())).device
    idx = torch.arange(n, device=dev)
    parts = [idx[lo:lo + batch_size] for lo in range(0, n, batch_size)]
    return _sums([eval_step((data, p))[0] for p in parts],
                 [len(p) for p in parts])


def eval_sums_host(eval_step, ds, batch_size: int, device, rank: int = 0,
                   world: int = 1) -> tuple:
    """The same over a host dataset, each batch copied to the device
    (:374-392); under data parallelism each rank takes its rows of every
    full batch and rank 0 the ragged last batch whole. eval_step:
    make_eval_step(..., device_data=False)."""
    losses, rows = [], []
    for b in batches(ds, batch_size, shuffle=False):
        if world > 1 and len(next(iter(b.values()))) == batch_size:
            b = local_rows(b, rank, world)
        elif world > 1 and rank:
            continue
        losses.append(eval_step(to_device_batch(b, device))[0])
        rows.append(len(next(iter(b.values()))))
    return _sums(losses, rows)


def evaluate(eval_step, data, n: int, batch_size: int) -> float:
    """The mean test loss over all n rows of `data` (eval_sums)."""
    total, rows = eval_sums(eval_step, data, n, batch_size)
    return total / rows


def evaluate_host(eval_step, ds, batch_size: int, device) -> float:
    """The mean test loss over a host dataset (eval_sums_host)."""
    total, rows = eval_sums_host(eval_step, ds, batch_size, device)
    return total / rows


def global_mean(sums, dp, device) -> float:
    """sum / rows of (sum, rows) added over the ranks of dp (None: this
    process alone), one all-reduce."""
    if dp is not None:
        t = torch.tensor(sums, dtype=torch.float64, device=device)
        sums = sum_in_place(dp.group, t).tolist()
    return sums[0] / sums[1]


def broadcast_state(model, dp):
    """Rank 0's parameters and buffers to every rank, in one broadcast a
    dtype over a flat buffer."""
    by_dtype = {}
    for t in list(model.parameters()) + list(model.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src=dist.get_global_rank(dp.group, 0),
                           group=dp.group)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))


def _step_terms(make_masks, mask_rng, k, device):
    """k steps' sampled (masks, lambdas), stacked on the device."""
    ms, ls = zip(*[make_masks(mask_rng) for _ in range(k)])
    return {key: torch.from_numpy(np.stack(v)).float().to(device)
            for key, v in (("masks", ms), ("lambdas", ls))}


def run_training(model, train_ds, test_ds, args, term_masks, term_lambdas,
                 *, out_dir, meta, eval_term_lambdas=None, device=None,
                 make_masks=None, eval_term_masks=None, recon_support=None,
                 fast_skip_decode=False, recon_masks=None,
                 eval_recon_masks=None, post_epoch=None):
    """Train `model` (already on `device`: None is the CUDA card, raises
    without one) for epochs start .. args.epochs; meta: {"model": the
    family, "n_latents"}, written into every checkpoint.
    eval_term_masks, eval_term_lambdas: the per-epoch eval's terms and
    weights, where they differ from training's (the MNIST families
    evaluate with 1s, as the reference's test() calls its ELBO without
    weights; celeba19 and vision evaluate the joint term alone;
    driver.py:38-40, 190-191). recon_masks, eval_recon_masks: (T, M)
    reconstruction masks apart from the posterior's (vision's unimodal
    terms reconstruct all six modalities), or None. make_masks: fn(np
    Generator) -> one step's (masks, lambdas) for a family with sampled
    terms (celeba19), whose steps then take those in place of term_masks
    and term_lambdas. recon_support, fast_skip_decode: make_train_step's
    (--fast-term-decode). post_epoch: fn(epoch, model), run after each
    epoch's eval on every rank (the model in eval mode). Under data
    parallelism (args' distributed flags, or a process group already up)
    the model is this rank's replica. Returns the model."""
    rank, world = maybe_initialize(args)
    dp = data_parallel(args.batch_size) if dist.is_initialized() else None
    coordinator = rank == 0
    log = print if coordinator else (lambda *a, **k: None)
    device = resolve_device(device)
    seed = args.seed
    generator = noise_generator(seed, device)
    mask_rng = np.random.default_rng(seed + 1)
    dynamic = make_masks is not None
    reckoned = reckoned_bytes(train_ds) + reckoned_bytes(test_ds)
    streaming = getattr(args, "no_device_data", False)
    device_data = not streaming and reckoned // world < DEVICE_DATA_BUDGET
    make_step = L.make_multi_train_step if device_data else L.make_train_step
    step = make_step(
        model, None if dynamic else term_masks,
        None if dynamic else term_lambdas, lr=args.lr, generator=generator,
        device=device, recon_support=recon_support,
        fast_skip_decode=fast_skip_decode, recon_masks=recon_masks, dp=dp)
    optimizer = step.optimizer
    start_epoch, best_loss = 1, float("inf")
    if args.resume:
        ckpt = load_checkpoint(args.resume, device=device)
        model.load_state_dict(ckpt["state_dict"], strict=True)
        if {"optimizer", "epoch", "generator"} <= set(ckpt):
            optimizer.load_state_dict(ckpt["optimizer"])
            generator.set_state(ckpt["generator"])
            if "mask_rng" in ckpt:
                mask_rng.bit_generator.state = ckpt["mask_rng"]
            start_epoch = ckpt["epoch"] + 1
            best_loss = ckpt["best_loss"]
            log(f"resumed from {args.resume} at epoch {ckpt['epoch']}")
        else:
            # a params-only file (the reference's own .pth.tar): warm-start
            # with a fresh optimizer and noise stream from epoch 1
            log(f"warm-started from {args.resume} (params only; "
                f"fresh optimizer)")
    if dp is not None:
        broadcast_state(model, dp)
        log(f"data-parallel over {world} processes (backend "
            f"{dist.get_backend(dp.group)}): {args.batch_size // world} of "
            f"each batch's {args.batch_size} rows a rank")

    eval_step = L.make_eval_step(
        model, term_masks if eval_term_masks is None else eval_term_masks,
        term_lambdas if eval_term_lambdas is None else eval_term_lambdas,
        device=device, device_data=device_data,
        recon_masks=eval_recon_masks)
    B, K = args.batch_size, max(1, args.log_interval)
    b = B // world                              # a rank's rows a step
    n_batches = num_batches(len(train_ds), B, True)
    if device_data:
        train_rows = shard_rows(len(train_ds), rank, world)
        test_rows = shard_rows(len(test_ds), rank, world)
        train_dev = to_device_data(train_ds, device, train_rows)
        test_dev = to_device_data(test_ds, device, test_rows)
        n_train = train_rows.stop - train_rows.start
        n_test = test_rows.stop - test_rows.start
        mib = sum(v.numel() * v.element_size() for v in train_dev.values())
        shard = f", a shard of 1/{world} a rank" if world > 1 else ""
        log(f"input pipeline: device-resident ({mib / 2 ** 20:.0f} MiB on "
            f"{device}{shard}), {K} steps/dispatch")
    else:
        why = ("--no-device-data" if streaming else
               f"over the {DEVICE_DATA_BUDGET / 2 ** 30:.0f} GiB budget")
        log(f"input pipeline: host streaming ({why}; "
            f"{reckoned / 2 ** 20:.0f} MiB reckoned), one batch copied to "
            f"{device} a step, {K} steps a log line")

    def global_losses(losses):
        """A window's (k,) losses on the device, averaged over the ranks,
        read back once."""
        if dp is not None:
            losses = sum_in_place(dp.group, losses).div_(world)
        return losses.tolist()

    def epoch_device(epoch, meter):
        n_steps = 0
        for lo, idxs in epoch_windows(seed, epoch, n_train, b, K, rank):
            k = len(idxs)
            betas = window_betas(epoch, lo, k, n_batches,
                                 args.annealing_epochs)
            # --profile-dir: the second window of the first epoch (the
            # first pays the kernel build and cuDNN's algorithm search)
            trace_now = bool(args.profile_dir and coordinator
                             and epoch == start_epoch
                             and (lo == K or (n_batches <= K and lo == 0)))
            terms = (_step_terms(make_masks, mask_rng, k, device) if dynamic
                     else {})
            with maybe_trace(args.profile_dir, trace_now, device):
                losses = global_losses(step(
                    train_dev, torch.from_numpy(idxs).to(device),
                    betas.to(device), **terms))
            for v in losses:                  # one readback a window
                meter.update(v, B)
            n_steps += k
            if coordinator:
                L.log_train(epoch, lo, B, len(train_ds), n_batches,
                            meter.avg, betas[0].item())
        return n_steps

    def epoch_host(epoch, meter):
        pending, rows, step_i = [], [], 0
        with contextlib.ExitStack() as trace:
            for batch in batches(train_ds, B, shuffle=True, seed=seed,
                                 epoch=epoch):
                beta = annealing_factor(epoch, step_i, n_batches,
                                        args.annealing_epochs)
                # --profile-dir: steps 2-4 of the first epoch (:306-308)
                if (args.profile_dir and coordinator and epoch == start_epoch
                        and step_i == 2):
                    trace.enter_context(maybe_trace(args.profile_dir, True,
                                                    device))
                terms = {}
                if dynamic:
                    terms = {k: v[0] for k, v in _step_terms(
                        make_masks, mask_rng, 1, device).items()}
                if dp is not None:
                    batch = local_rows(batch, rank, world)
                loss, _ = step(to_device_batch(batch, device), beta, **terms)
                pending.append(loss)
                rows.append(B)
                if step_i == 4:
                    trace.close()
                if step_i % K == 0:       # one readback a log line
                    for v, n in zip(global_losses(torch.stack(pending)),
                                    rows):
                        meter.update(v, n)
                    pending, rows = [], []
                    if coordinator:
                        L.log_train(epoch, step_i, B, len(train_ds),
                                    n_batches, meter.avg, beta)
                step_i += 1
        for v, n in zip(global_losses(torch.stack(pending)) if pending
                        else [], rows):
            meter.update(v, n)
        return step_i

    def test_loss():
        if device_data:
            sums = eval_sums(eval_step, test_dev, n_test, b)
            left = len(test_ds) % world     # the rows no shard holds
            if coordinator and left:
                tail = to_device_data(test_ds, device, slice(
                    len(test_ds) - left, None))
                extra = eval_sums(eval_step, tail, left, left)
                sums = (sums[0] + extra[0], sums[1] + extra[1])
        else:
            sums = eval_sums_host(eval_step, test_ds, B, device, rank, world)
        return global_mean(sums, dp, device)

    for epoch in range(start_epoch, args.epochs + 1):
        meter = L.AverageMeter()
        epoch_t0 = time.perf_counter()
        n_steps = (epoch_device if device_data else epoch_host)(epoch, meter)
        epoch_dt = time.perf_counter() - epoch_t0
        if coordinator:
            L.log_epoch(epoch, meter.avg)
        if n_steps > 1 and epoch > start_epoch:   # not the warm-up epoch
            log('====> Throughput: {:.2f} steps/sec'.format(
                n_steps / epoch_dt))

        loss = test_loss()
        if coordinator:
            L.log_test(loss)
        if post_epoch is not None:
            post_epoch(epoch, model)
        is_best = loss < best_loss
        best_loss = min(loss, best_loss)
        if coordinator:
            extra = ({"mask_rng": mask_rng.bit_generator.state} if dynamic
                     else {})
            save_checkpoint(dict(meta, state_dict=model.state_dict(),
                                 optimizer=optimizer.state_dict(),
                                 epoch=epoch,
                                 generator=generator.get_state(),
                                 best_loss=float(best_loss),
                                 test_loss=float(loss), **extra),
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
