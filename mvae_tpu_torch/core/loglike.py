"""Importance-sampled marginal log-likelihood (counterpart of
mvae_tpu/core/loglike.py): the IWAE bound (Burda et al. 2016) with the
fused posterior q(z|.) as the proposal,

    log p(x) >= logsumexp_k [log p(x|z_k) + log p(z_k) - log q(z_k|.)]
                - log K

The K samples of a batch decode as one batch of K*B rows, sample-major
(row k*B + b is sample k of example b): eval-mode BatchNorm acts row by row,
so this equals K decodes of B rows, and the losses read target row b for
row k*B + b (ops/elbo.py, core/losses.py) without a copy of the targets.
Where K*B rows would hold more than DECODE_ELEMENTS logit elements, the K
samples split into the fewest equal chunks that do not.
"""

import math

import numpy as np
import torch

from mvae_tpu_torch.ops.poe import masked_poe_all_terms
from mvae_tpu_torch.utils.profiling import span

DECODE_ELEMENTS = 2 ** 28       # logit elements one decode may hold (1 GiB
                                # in f32): CelebA's K = 100 at B = 100 is one


def _log_normal(z, mu, logvar):
    """log N(z; mu, diag(exp(logvar))), summed over the last axis."""
    return -0.5 * torch.sum(logvar + math.log(2.0 * math.pi)
                            + (z - mu).square() * torch.exp(-logvar), dim=-1)


def decode_chunks(k: int, rows: int, row_elements: int) -> int:
    """The fewest equal chunks of k samples whose rows (k / chunks * rows
    decoded rows of row_elements logits each) fit DECODE_ELEMENTS."""
    return next(c for c in range(1, k + 1) if k % c == 0 and (
        c == k or k // c * rows * row_elements <= DECODE_ELEMENTS))


def _row_elements(model) -> int:
    """Logit elements a decoded row holds, from the input spec (a label
    modality counts as one: its logits are a few classes)."""
    return sum(int(np.prod(shape)) for shape, _ in model.input_spec().values())


@torch.inference_mode()
def iwae_log_marginal(model, inputs, proposal_mask, target_names, k: int, *,
                      eps=None, generator=None):
    """Estimate log p(targets) for a batch; returns (B,) f32.

    inputs:        name -> (B, ...) tensors on the model's device, every
                   modality present (placeholders for the ones outside
                   the proposal).
    proposal_mask: (M,) 0/1, the modalities q conditions on.
    target_names:  the modalities whose reconstruction terms enter
                   log p(x|z) (the model's recon_loss is the negative
                   log-likelihood).
    eps:           (K, B, D) standard normal draws, or None to draw them
                   from `generator` (a torch.Generator on the device).
    The model runs in eval mode: one encode, one PoE launch with one mask
    row, then the decodes of the K*B sample rows.
    """
    model.eval()
    dev = model.device
    with span("mvae.score.batch"):
        with span("mvae.score.encode"):
            mu, logvar, _ = model.encode(inputs)
        with span("mvae.score.fuse"):
            mask = torch.as_tensor(proposal_mask, dtype=torch.float32,
                                   device=dev).reshape(1, -1)
            q_mu, q_lv = (t[0] for t in masked_poe_all_terms(mu, logvar,
                                                             mask))
            b, d = q_mu.shape
            if eps is None:
                if generator is None:
                    raise ValueError("iwae_log_marginal takes eps or a "
                                     "generator")
                eps = torch.randn((k, b, d), generator=generator, device=dev)
            z = q_mu + eps * torch.exp(0.5 * q_lv)           # (K, B, D)
        kc = k // decode_chunks(k, b, _row_elements(model))
        log_px_z = []
        for lo in range(0, k, kc):
            with span("mvae.score.decode"):
                recons, _ = model.decode(z[lo:lo + kc].reshape(kc * b, d))
            with span("mvae.score.weights"):
                lp = 0.0
                for name in target_names:
                    lp = lp - model.recon_loss(name, recons[name],
                                               inputs[name])
                log_px_z.append(lp.reshape(kc, b))
        with span("mvae.score.weights"):
            log_pz = -0.5 * torch.sum(math.log(2.0 * math.pi) + z.square(),
                                      dim=-1)
            log_w = torch.cat(log_px_z) + log_pz - _log_normal(z, q_mu, q_lv)
            return torch.logsumexp(log_w, dim=0) - math.log(k)
