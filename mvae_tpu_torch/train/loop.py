"""Train and eval steps, the input decode and the driver's logging
(counterpart of mvae_tpu/train/loop.py:16-51, 63-125, 146-300).

Data parallelism (`dp`, a parallel.mesh.DataParallel of N ranks): each
rank steps on its B / N rows of a global batch of B, and the step gives
every rank the values one device gives on the whole batch, up to the
order of the sums. The BNs share their batch statistics across the ranks
(nn/norm.py:set_bn_sync); the noise is drawn at the global batch's shape
from the generator every rank seeds alike, and each rank keeps its rows
(local_noise); after the backward the gradients are averaged across the
ranks in one all-reduce over a flat buffer (average_gradients), so Adam
steps every replica on the same gradient and the replicas stay equal. The
per-term mean over a rank's rows (core/engine.py) averages to the mean
over the global batch through that average. This is the JAX package's
GSPMD step on a "data" mesh axis (parallel/data_parallel.py:44's pmean
written out).

Tensor and expert parallelism (a dp with a model axis, the model sharded
by parallel/mesh.py:shard_params_tp): the ranks of one dp index hold the
same rows and split the sharded parameters. Everything above is keyed by
the dp index and runs over the dp group: the BN statistics, the noise's
rows, a sharded parameter's gradient average (its gradient is whole on
its rank: the tp collectives of nn/layers.py complete it). A replicated
parameter's gradient is averaged over the world instead: the tp ranks of
a dp index hold it alike up to the rounding of kernels that are not
deterministic (cuDNN's f32 weight gradients on the card), and the
world's mean, the dp group's mean to that rounding, keeps the replicas
bit for bit equal; for the same reason the BN running statistics are
averaged over the world after each step. The encoder dropout's keep-mask is drawn whole,
(B, hidden), and a rank keeps the columns of its slice of the head's
hidden features. It does not go through DistributedDataParallel: the step
drives the model through core/engine.py:multi_term_elbo, not forward(),
and a step may leave parameters without a gradient (celeba19's sampled
terms, --fast-term-decode), which DDP handles only with
find_unused_parameters and an extra pass over the graph.
"""

import torch
import torch.distributed as dist

from mvae_tpu_torch.core.engine import (
    decode_plan, multi_term_elbo, rows_axis, static_support)
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.nn.norm import BatchNorm, set_bn_sync
from mvae_tpu_torch.parallel.collectives import sum_in_place
from mvae_tpu_torch.utils.profiling import span


def decode_batch(batch, dtype=torch.float32):
    """uint8 image tensors become `dtype` in [0, 1]; other dtypes pass
    through. In bf16 the quotient rounds once to bf16, as
    `v.astype(bf16) / bf16(255)` does in the JAX package."""
    return {k: (v.to(dtype) / 255 if v.dtype == torch.uint8 else v)
            for k, v in batch.items()}


def resolve_decode_dtype(model, decode_dtype=None):
    """The input-decode dtype: `decode_dtype` if given, else bf16 when the
    model computes in bf16 and f32 otherwise (train/loop.py:32-51)."""
    if decode_dtype is not None:
        return decode_dtype
    if getattr(model, "compute_dtype", None) == torch.bfloat16:
        return torch.bfloat16
    return torch.float32


def _check_device(model, device, what):
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"the model lives on {model.device}, the {what} "
                         f"was asked to run on {device}")
    return device


def _gather(batch, device_data):
    if device_data:
        data, idx = batch
        return {k: v.index_select(0, idx) for k, v in data.items()}
    return batch


def _masks(term_masks, device):
    return (None if term_masks is None else
            torch.as_tensor(term_masks, dtype=torch.float32, device=device))


def make_eval_step(model, term_masks, term_lambdas, *, device=None,
                   device_data: bool = False, decode_dtype=None,
                   recon_masks=None):
    """Eval: beta = 1, z = mu, running BN statistics, no dropout (reference
    test(): mnist/train.py:229-253). Each call puts the model in eval mode.

    device: None runs on the CUDA card (raises without one), "cpu" on the
    CPU; the model must already live there.
    device_data=True: the step takes (data, idx) with `data` the whole
    dataset on the device and idx the (B,) batch rows; the gather runs on
    the device. recon_masks: (T, M) reconstruction masks apart from the
    posterior's (core/engine.py:multi_term_elbo), or None.

    Step signature: eval_step(batch) -> (total, per_term (T,)).
    """
    device = _check_device(model, device, "eval step")
    masks = _masks(term_masks, device)
    lambdas = _masks(term_lambdas, device)
    rmasks = _masks(recon_masks, device)
    decode_dt = resolve_decode_dtype(model, decode_dtype)

    @torch.inference_mode()
    def eval_step(batch):
        model.eval()
        batch = decode_batch(_gather(batch, device_data), decode_dt)
        total, aux = multi_term_elbo(model, batch, masks, lambdas, 1.0,
                                     train=False, recon_masks=rmasks)
        return total, aux["per_term"]

    return eval_step


def draw_noise(model, n_terms: int, batch: int, generator):
    """The train step's noise from `generator` (a torch.Generator on the
    model's device): eps (T, B, D) standard normal for the reparametrization
    and the encoder dropout's keep-mask, Bernoulli(1 - rate) as
    `jax.random.bernoulli` draws it (uniform < keep); a model without
    dropout gets None and no draw. A model with a decoder dropout
    (decode_dropout_rate: MultiMNIST's text decoder) gets a third entry,
    its keep-masks for the T * B decoded rows, drawn after the others, so
    the other families' streams are those of a model without it."""
    dev = model.device
    eps = torch.randn((n_terms, batch, model.n_latents), generator=generator,
                      device=dev)
    keep = None
    if model.dropout_rate:
        u = torch.rand(model.keep_mask_shape(batch), generator=generator,
                       device=dev)
        keep = u < 1.0 - model.dropout_rate
    rate = getattr(model, "decode_dropout_rate", 0.0)
    if not rate:
        return eps, keep
    u = torch.rand(model.decode_keep_mask_shape(n_terms * batch),
                   generator=generator, device=dev)
    return eps, keep, u < 1.0 - rate


def local_noise(model, noise, dp):
    """This rank's rows of the train step's noise for the global batch:
    eps (T, B, D) and the encoder's keep-mask at their batch axis, the
    decoder's keep-masks for the T * B decoded rows (term-major) at the
    rows of each term; the rows of the dp index. Where the head's fc is a
    column layer, the encoder's keep-mask keeps the tp index's columns of
    its last axis (the head's hidden features)."""
    eps, keep = noise[:2]
    t, rows = eps.shape[:2]
    b = rows // dp.world
    lo = dp.rank * b
    if keep is not None:
        keep = keep.narrow(rows_axis(model.keep_mask_shape, rows), lo, b)
        tp = model.dropout_tp()
        if tp is not None and tp.kind == "col":
            cols = keep.shape[-1] // dp.tp_world
            keep = keep.narrow(-1, dp.tp_rank * cols, cols)
    out = [eps[:, lo:lo + b], keep]
    if len(noise) > 2:
        dec = noise[2]
        ax = rows_axis(model.decode_keep_mask_shape, t * rows)
        shape = dec.shape
        dec = dec.reshape(shape[:ax] + (t, rows) + shape[ax + 1:])
        out.append(dec.narrow(ax + 1, lo, b).reshape(
            shape[:ax] + (t * b,) + shape[ax + 1:]))
    return tuple(out)


def _average(params, group, world):
    """Each parameter's gradient replaced by its mean across the group's
    `world` ranks, one all-reduce over a flat buffer a dtype."""
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([(torch.zeros_like(p) if p.grad is None
                           else p.grad).reshape(-1) for p in ps])
        sum_in_place(group, flat).div_(world)
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad = g.view_as(p)


def average_running_stats(model, group, world):
    """The BNs' running means and variances averaged across the group's
    `world` ranks, in one all-reduce over a flat buffer (none without a
    BN)."""
    bufs = [b for m in model.modules() if isinstance(m, BatchNorm)
            for b in (m.running_mean, m.running_var)]
    if not bufs:
        return
    flat = sum_in_place(group, torch.cat(bufs)).div_(world)
    for b, v in zip(bufs, flat.split([b.numel() for b in bufs])):
        b.copy_(v)


def average_gradients(params, dp, sharded=()):
    """Replace every parameter's gradient by its mean across the ranks (the
    parameters are f32): over the dp group, or, with a model axis, the
    `sharded` ones over the dp group and the others over the world (the
    module docstring). A gradient that is None on this rank counts as
    zeros, since another rank may have one: every parameter leaves with
    a gradient, as in the JAX package, whose gradients are dense."""
    if dp.tp_world == 1:
        _average(params, dp.group, dp.world)
        return
    mine = {id(p) for p in sharded}
    split = ([p for p in params if id(p) in mine],
             [p for p in params if id(p) not in mine])
    for ps, group, world in zip(split, (dp.group, dist.group.WORLD),
                                (dp.world, dp.world * dp.tp_world)):
        if ps:
            _average(ps, group, world)


def make_train_step(model, term_masks, term_lambdas, *, lr: float,
                    generator, device=None, device_data: bool = False,
                    recon_support=None, fast_skip_decode: bool = False,
                    recon_masks=None, dp=None, sync_bn: bool = True):
    """One training step: the train-mode multi-term ELBO, its backward, an
    Adam update and the BN running-statistics commit.

    term_masks, term_lambdas: (T, M), or None for a step that takes each
    step's own (celeba19's sampled terms). recon_support: numpy (T, M)
    0/1, the static support of the recon weights (each step's must lie
    within it), from which the step's decode is grouped
    (core/engine.py:decode_plan); None derives it from static masks
    (static_support, train/loop.py:94-95 in the JAX package) and leaves a
    step with per-call terms and no support the one-batch decode. An
    all-ones support gives the one-batch decode too (the A/B of the two).
    fast_skip_decode: the grouped decode also skips the model's
    skip_decode_groups for the terms that never train them
    (--fast-term-decode). recon_masks: (T, M) reconstruction masks apart
    from the posterior's (vision), or None.

    Adam is torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8), the same
    update as optax.adam (m_hat / (sqrt(v_hat) + eps)), its state in f32;
    the step owns it (`train_step.optimizer`). generator: the
    torch.Generator on the model's device that the noise is drawn from.
    device and device_data as in make_eval_step. Each call puts the model
    in train mode.

    dp: a parallel.mesh.DataParallel (the module docstring), or None for
    one device. The step then takes this rank's B / N rows of each batch,
    draws (or is given) the noise of the global batch of B rows and keeps
    its own, and averages the gradients; sync_bn=False leaves each rank's
    BNs their own rows' statistics (parallel/data_parallel.py).

    Step signature: train_step(batch, beta, noise=None, masks=None,
    lambdas=None) -> (loss, per_term (T,)), detached tensors on the
    device, read by nobody; under dp this rank's (the mean of the ranks'
    losses is the global batch's). noise = (eps, keep_mask[,
    decode_keep_mask]) replaces the draw (tests feed the JAX package's);
    masks, lambdas: this step's (T, M) tensors on the device, in place of
    the step's own.
    """
    device = _check_device(model, device, "train step")
    masks = _masks(term_masks, device)
    lambdas = _masks(term_lambdas, device)
    rmasks = _masks(recon_masks, device)
    if recon_support is None and term_masks is not None:
        recon_support = static_support(term_masks, term_lambdas,
                                       recon_masks)
    plan = decode_plan(model, recon_support,
                       fast_skip_decode=fast_skip_decode, device=device)
    decode_dt = resolve_decode_dtype(model)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)

    params = list(model.parameters())
    tp_plan = getattr(getattr(model, "tp_layout", None), "plan", {})
    sharded = [p for n, p in model.named_parameters()
               if tp_plan.get(n) is not None]
    bn_group = dp.group if dp is not None and sync_bn else None

    def train_step(batch, beta, noise=None, masks=masks, lambdas=lambdas):
        with span("mvae.train.step"):
            return _step(batch, beta, noise, masks, lambdas)

    def _step(batch, beta, noise, masks, lambdas):
        model.train()
        set_bn_sync(model, bn_group)
        with span("mvae.train.gather"):
            batch = decode_batch(_gather(batch, device_data), decode_dt)
        with span("mvae.train.noise"):
            if noise is None:
                b = next(iter(batch.values())).shape[0]
                noise = draw_noise(model, masks.shape[0],
                                   b * (1 if dp is None else dp.world),
                                   generator)
            if dp is not None:
                noise = local_noise(model, noise, dp)
        with span("mvae.train.adam"):
            optimizer.zero_grad(set_to_none=True)
        total, aux = multi_term_elbo(model, batch, masks, lambdas, beta,
                                     train=True, noise=noise,
                                     plan=plan,
                                     recon_masks=rmasks)
        with span("mvae.train.backward"):
            total.backward()
        if dp is not None:
            with span("mvae.train.allreduce"):
                average_gradients(params, dp, sharded)
        with span("mvae.train.adam"):
            optimizer.step()
        if dp is not None and dp.tp_world > 1:
            with span("mvae.train.allreduce"), torch.no_grad():
                average_running_stats(model, dist.group.WORLD,
                                      dp.world * dp.tp_world)
        return total.detach(), aux["per_term"].detach()

    train_step.optimizer = optimizer
    train_step.plan = plan
    return train_step


def make_multi_train_step(model, term_masks, term_lambdas, *, lr: float,
                          generator, device=None, recon_support=None,
                          fast_skip_decode: bool = False, recon_masks=None,
                          dp=None, sync_bn: bool = True):
    """K training steps per call over the device-resident dataset, with one
    loss buffer to read back (train/loop.py:146-212).

    Step signature: multi_step(data, idxs (K, B), betas (K,), noise=None,
    masks=None, lambdas=None) -> losses (K,), a tensor on the device that
    the caller reads once. data: name -> the whole dataset on the device
    (uint8 images); each step gathers its rows with index_select and
    decodes them in the model's decode dtype. noise: optional (eps (K, T,
    B, D), keep_mask (K, B, H) or None without dropout[, the decoder's
    (K, ...) keep-masks]) in place of the generator's draws. masks,
    lambdas: (K, T, M), each step's terms, where the step has none of its
    own (term_masks None); the other arguments as make_train_step's. Under
    dp, data is this rank's resident rows, idxs index them (B / N a step),
    and noise is the global batch's.

    The K steps run as K eager steps; capturing the window as one CUDA
    graph is a later speed item.
    """
    step = make_train_step(model, term_masks, term_lambdas, lr=lr,
                           generator=generator, device=device,
                           device_data=True, recon_support=recon_support,
                           fast_skip_decode=fast_skip_decode,
                           recon_masks=recon_masks, dp=dp, sync_bn=sync_bn)

    def multi_step(data, idxs, betas, noise=None, masks=None, lambdas=None):
        with span("mvae.train.window"):
            losses = []
            for k in range(idxs.shape[0]):
                nk = None if noise is None else tuple(
                    None if n is None else n[k] for n in noise)
                terms = {} if masks is None else dict(masks=masks[k],
                                                      lambdas=lambdas[k])
                losses.append(step((data, idxs[k]), betas[k], nk,
                                   **terms)[0])
            return torch.stack(losses)

    multi_step.optimizer = step.optimizer
    multi_step.plan = step.plan
    return multi_step


class AverageMeter:
    """Running mean for logging (mnist/train.py:97-112)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def log_train(epoch, batch_idx, batch_size, n_examples, n_batches, avg_loss,
              beta):
    """The reference's log line (mnist/train.py:221-224)."""
    print('Train Epoch: {} [{}/{} ({:.0f}%)]\tLoss: {:.6f}\t'
          'Annealing-Factor: {:.3f}'.format(
              epoch, batch_idx * batch_size, n_examples,
              100.0 * batch_idx / n_batches, avg_loss, beta))


def log_epoch(epoch, avg_loss):
    print('====> Epoch: {}\tLoss: {:.4f}'.format(epoch, avg_loss))


def log_test(avg_loss):
    print('====> Test Loss: {:.4f}'.format(avg_loss))
