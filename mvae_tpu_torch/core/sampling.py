"""Reparameterization (counterpart of mvae_tpu/core/sampling.py)."""

import torch


def reparametrize(mu, logvar, *, train: bool, generator=None):
    """mu + eps * exp(0.5 * logvar) in training, with eps drawn from
    `generator` (a torch.Generator on mu's device); mu in eval
    (mnist/model.py:29-35)."""
    if not train:
        return mu
    eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                      dtype=mu.dtype)
    return mu + eps * torch.exp(0.5 * logvar)
