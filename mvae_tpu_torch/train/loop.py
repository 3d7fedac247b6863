"""Train and eval steps, the input decode and the driver's logging
(counterpart of mvae_tpu/train/loop.py:16-51, 63-125, 146-300)."""

import torch

from mvae_tpu_torch.core.engine import multi_term_elbo
from mvae_tpu_torch.device import resolve_device


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


def make_eval_step(model, term_masks, term_lambdas, *, device=None,
                   device_data: bool = False, decode_dtype=None):
    """Eval: beta = 1, z = mu, running BN statistics, no dropout (reference
    test(): mnist/train.py:229-253). Each call puts the model in eval mode.

    device: None runs on the CUDA card (raises without one), "cpu" on the
    CPU; the model must already live there.
    device_data=True: the step takes (data, idx) with `data` the whole
    dataset on the device and idx the (B,) batch rows; the gather runs on
    the device.

    Step signature: eval_step(batch) -> (total, per_term (T,)).
    """
    device = _check_device(model, device, "eval step")
    masks = torch.as_tensor(term_masks, dtype=torch.float32, device=device)
    lambdas = torch.as_tensor(term_lambdas, dtype=torch.float32,
                              device=device)
    decode_dt = resolve_decode_dtype(model, decode_dtype)

    @torch.inference_mode()
    def eval_step(batch):
        model.eval()
        batch = decode_batch(_gather(batch, device_data), decode_dt)
        total, aux = multi_term_elbo(model, batch, masks, lambdas, 1.0,
                                     train=False)
        return total, aux["per_term"]

    return eval_step


def draw_noise(model, n_terms: int, batch: int, generator):
    """The train step's noise from `generator` (a torch.Generator on the
    model's device): eps (T, B, D) standard normal for the reparametrization
    and the encoder dropout's keep-mask, Bernoulli(1 - rate) as
    `jax.random.bernoulli` draws it (uniform < keep); a model without
    dropout gets None and no draw."""
    dev = model.device
    eps = torch.randn((n_terms, batch, model.n_latents), generator=generator,
                      device=dev)
    if not model.dropout_rate:
        return eps, None
    keep = 1.0 - model.dropout_rate
    u = torch.rand(model.keep_mask_shape(batch), generator=generator,
                   device=dev)
    return eps, u < keep


def make_train_step(model, term_masks, term_lambdas, *, lr: float,
                    generator, device=None, device_data: bool = False):
    """One training step: the train-mode multi-term ELBO, its backward, an
    Adam update and the BN running-statistics commit.

    Adam is torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8), the same
    update as optax.adam (m_hat / (sqrt(v_hat) + eps)), its state in f32;
    the step owns it (`train_step.optimizer`). generator: the
    torch.Generator on the model's device that the noise is drawn from.
    device and device_data as in make_eval_step. Each call puts the model
    in train mode.

    Step signature: train_step(batch, beta, noise=None) -> (loss, per_term
    (T,)), detached tensors on the device, read by nobody. noise = (eps,
    keep_mask) replaces the draw (tests feed the JAX package's).
    """
    device = _check_device(model, device, "train step")
    masks = torch.as_tensor(term_masks, dtype=torch.float32, device=device)
    lambdas = torch.as_tensor(term_lambdas, dtype=torch.float32,
                              device=device)
    decode_dt = resolve_decode_dtype(model)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)

    def train_step(batch, beta, noise=None):
        model.train()
        batch = decode_batch(_gather(batch, device_data), decode_dt)
        if noise is None:
            b = next(iter(batch.values())).shape[0]
            noise = draw_noise(model, masks.shape[0], b, generator)
        optimizer.zero_grad(set_to_none=True)
        total, aux = multi_term_elbo(model, batch, masks, lambdas, beta,
                                     train=True, noise=noise)
        total.backward()
        optimizer.step()
        return total.detach(), aux["per_term"].detach()

    train_step.optimizer = optimizer
    return train_step


def make_multi_train_step(model, term_masks, term_lambdas, *, lr: float,
                          generator, device=None):
    """K training steps per call over the device-resident dataset, with one
    loss buffer to read back (train/loop.py:146-212).

    Step signature: multi_step(data, idxs (K, B), betas (K,), noise=None)
    -> losses (K,), a tensor on the device that the caller reads once.
    data: name -> the whole dataset on the device (uint8 images); each
    step gathers its rows with index_select and decodes them in the
    model's decode dtype. noise: optional (eps (K, T, B, D), keep_mask
    (K, B, H) or None without dropout) in place of the generator's draws.

    The K steps run as K eager steps; capturing the window as one CUDA
    graph is a later speed item.
    """
    step = make_train_step(model, term_masks, term_lambdas, lr=lr,
                           generator=generator, device=device,
                           device_data=True)

    def multi_step(data, idxs, betas, noise=None):
        losses = []
        for k in range(idxs.shape[0]):
            nk = None if noise is None else (
                noise[0][k], None if noise[1] is None else noise[1][k])
            losses.append(step((data, idxs[k]), betas[k], nk)[0])
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
