"""Loss primitives with the reference's numerics (counterpart of
mvae_tpu/core/losses.py:11-86). Decoders emit logits; activations live in
the loss."""

import torch

from mvae_tpu_torch.ops.elbo import bce_sum


def binary_cross_entropy_with_logits(logits, targets):
    """Stable sigmoid + BCE, elementwise: max(x,0) - x*t + log1p(exp(-|x|))
    (mnist/train.py:62-74)."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def bce_row_sum(logits, targets, bf16_math=False):
    """Row sums of the stable BCE in f32: (N, K) logits, (Nt, K) targets
    with N % Nt == 0 (each group of Nt rows shares the targets) -> (N,).

    Logits and targets may each be f32 or bf16; both are read as they are
    and upcast inside (ops.elbo.bce_sum: the kernel on the card, the plain
    version on the CPU). bf16_math=True with bf16 logits computes the
    elementwise math in bf16 steps, the sums in f32 (the JAX package's
    MVAE_BF16_LOSS=1 branch, as an argument; ops/elbo.py)."""
    return bce_sum(logits, targets, bf16_math)


def cross_entropy_with_logits(logits, labels, eps: float = 1e-6):
    """k-class CE per row: -log_softmax(logits + eps)[label], with eps added
    to the logits as the reference does (mnist/train.py:77-94; the JAX
    package's core/losses.py:21-32), in the logits' dtype.

    logits: (N, K); labels: (Nt,) int with N % Nt == 0: row r reads label
    r mod Nt (the IWAE's K*B sample rows share the B labels), no copy."""
    n, k = logits.shape
    nt = labels.shape[0]
    logp = torch.log_softmax(logits + eps, dim=-1).reshape(n // nt, nt, k)
    idx = labels.long().view(1, nt, 1).expand(n // nt, nt, 1)
    return -logp.gather(-1, idx).reshape(n)


def kl_divergence(mu, logvar):
    """KL(q || N(0, I)) summed over the last axis:
    -0.5 * sum(1 + logvar - mu^2 - exp(logvar))  (mnist/train.py:56)."""
    return -0.5 * torch.sum(1.0 + logvar - mu.square() - torch.exp(logvar),
                            dim=-1)
