"""Reparameterization (counterpart of mvae_tpu/core/sampling.py)."""

import torch


def reparametrize(mu, logvar, eps=None):
    """mu + eps * exp(0.5 * logvar) in training, with the standard normal
    noise eps (mu's shape) drawn by the caller; mu in eval, when eps is
    None (mnist/model.py:29-35)."""
    if eps is None:
        return mu
    return mu + eps * torch.exp(0.5 * logvar)
