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
written out). It does not go through DistributedDataParallel: the step
drives the model through core/engine.py:multi_term_elbo, not forward(),
and a step may leave parameters without a gradient (celeba19's sampled
terms, --fast-term-decode), which DDP handles only with
find_unused_parameters and an extra pass over the graph.
"""

import torch

from mvae_tpu_torch.core.engine import fast_decode_terms, multi_term_elbo
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.nn.norm import set_bn_sync
from mvae_tpu_torch.parallel.collectives import sum_in_place


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


def _batch_axis(shape_of, rows: int) -> int:
    """The axis of shape_of(rows) that counts the rows."""
    return next(i for i, (a, b) in enumerate(zip(shape_of(rows),
                                                 shape_of(rows + 1)))
                if a != b)


def local_noise(model, noise, dp):
    """This rank's rows of the train step's noise for the global batch:
    eps (T, B, D) and the encoder's keep-mask at their batch axis, the
    decoder's keep-masks for the T * B decoded rows (term-major) at the
    rows of each term."""
    eps, keep = noise[:2]
    t, rows = eps.shape[:2]
    b = rows // dp.world
    lo = dp.rank * b
    out = [eps[:, lo:lo + b],
           None if keep is None else
           keep.narrow(_batch_axis(model.keep_mask_shape, rows), lo, b)]
    if len(noise) > 2:
        dec = noise[2]
        ax = _batch_axis(model.decode_keep_mask_shape, t * rows)
        shape = dec.shape
        dec = dec.reshape(shape[:ax] + (t, rows) + shape[ax + 1:])
        out.append(dec.narrow(ax + 1, lo, b).reshape(
            shape[:ax] + (t * b,) + shape[ax + 1:]))
    return tuple(out)


def average_gradients(params, dp):
    """Replace every parameter's gradient by its mean across the ranks, in
    one all-reduce over a flat buffer a dtype (the parameters are f32).
    A gradient that is None on this rank counts as zeros, since another
    rank may have one: every parameter leaves with a gradient, as in the
    JAX package, whose gradients are dense."""
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([(torch.zeros_like(p) if p.grad is None
                           else p.grad).reshape(-1) for p in ps])
        sum_in_place(dp.group, flat).div_(dp.world)
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad = g.view_as(p)


def make_train_step(model, term_masks, term_lambdas, *, lr: float,
                    generator, device=None, device_data: bool = False,
                    recon_support=None, fast_skip_decode: bool = False,
                    recon_masks=None, dp=None, sync_bn: bool = True):
    """One training step: the train-mode multi-term ELBO, its backward, an
    Adam update and the BN running-statistics commit.

    term_masks, term_lambdas: (T, M), or None for a step that takes each
    step's own (celeba19's sampled terms). fast_skip_decode: decode the
    model's skip_decode_groups only for the terms whose recon_support
    (numpy (T, M) 0/1) holds them (--fast-term-decode,
    core/engine.py:fast_decode_terms). recon_masks: (T, M) reconstruction
    masks apart from the posterior's (vision), or None.

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
    decode_terms = (fast_decode_terms(model, recon_support, device)
                    if fast_skip_decode else None)
    decode_dt = resolve_decode_dtype(model)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)

    params = list(model.parameters())
    bn_group = dp.group if dp is not None and sync_bn else None

    def train_step(batch, beta, noise=None, masks=masks, lambdas=lambdas):
        model.train()
        set_bn_sync(model, bn_group)
        batch = decode_batch(_gather(batch, device_data), decode_dt)
        if noise is None:
            b = next(iter(batch.values())).shape[0]
            noise = draw_noise(model, masks.shape[0],
                               b * (1 if dp is None else dp.world),
                               generator)
        if dp is not None:
            noise = local_noise(model, noise, dp)
        optimizer.zero_grad(set_to_none=True)
        total, aux = multi_term_elbo(model, batch, masks, lambdas, beta,
                                     train=True, noise=noise,
                                     decode_terms=decode_terms,
                                     recon_masks=rmasks)
        total.backward()
        if dp is not None:
            average_gradients(params, dp)
        optimizer.step()
        return total.detach(), aux["per_term"].detach()

    train_step.optimizer = optimizer
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
        losses = []
        for k in range(idxs.shape[0]):
            nk = None if noise is None else tuple(
                None if n is None else n[k] for n in noise)
            terms = {} if masks is None else dict(masks=masks[k],
                                                  lambdas=lambdas[k])
            losses.append(step((data, idxs[k]), betas[k], nk, **terms)[0])
        return torch.stack(losses)

    multi_step.optimizer = step.optimizer
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
