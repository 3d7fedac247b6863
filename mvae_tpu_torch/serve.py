"""Serving endpoints (counterpart of mvae_tpu/serve.py).

    sampler = Sampler.from_checkpoint("model_best.pth.tar")
    imgs = sampler.sample(n=64, seed=0)                        # prior
    imgs = sampler.sample(n=64, condition={"attrs": a})        # conditional
    mu, logvar = sampler.embed({"image": batch})               # posterior
    recs = sampler.reconstruct({"image": batch})               # cross-modal

Every endpoint is a deterministic function of (weights, inputs, seed).
Request sizes are bucketed to the next power of two (pad, then slice), as
in the JAX package, so a traffic mix sees a few fixed batch shapes.
Outputs are activated as in the JAX package (serve.py:113-118): a softmax
over the last axis (the classes) of a "text" modality of rank 2 or more
(MNIST's (N, 10), MultiMNIST's (N, 4, 12)), a sigmoid of the logits
otherwise; images NHWC.
"""

import torch

from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models import model_ctor
from mvae_tpu_torch.utils.weights import (
    checkpoint_family, load_reference_checkpoint)


def activate(recons):
    """Decoder logits -> the endpoints' outputs."""
    return {k: (torch.softmax(v, dim=-1) if k == "text" and v.ndim >= 2
                else torch.sigmoid(v)) for k, v in recons.items()}


def _bucket(n: int) -> int:
    """Next power of two >= n (min 1)."""
    return 1 << max(0, (n - 1).bit_length())


def _pad_rows(x, m):
    """Pad the leading axis to m rows by repeating row 0 (sliced off after
    the call)."""
    n = x.shape[0]
    if n == m:
        return x
    return torch.cat([x, x[:1].expand((m - n,) + tuple(x.shape[1:]))])


class Sampler:
    def __init__(self, model, *, device=None):
        """model: an eval-mode model on `device` (None: the CUDA card,
        raises without one; "cpu": the CPU)."""
        device = resolve_device(device)
        if model.device != device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"sampler was asked to serve on {device}")
        self.model = model.eval()
        self.device = device

    @classmethod
    def from_checkpoint(cls, path, *, device=None, compute_dtype=None):
        """Serve a reference-layout `.pth.tar` of a ported family: the
        port's own checkpoints, which name it, and those of the JAX
        package's utils/torch_export.py:export_checkpoint or the
        reference, whose keys tell it (utils/weights.py:
        checkpoint_family)."""
        device = resolve_device(device)
        sd, meta = load_reference_checkpoint(path, device=device)
        model = model_ctor(checkpoint_family(sd, meta))(
            meta["n_latents"], compute_dtype, device=device)
        model.load_state_dict(sd, strict=True)
        return cls(model, device=device)

    def _tensor(self, x):
        return torch.as_tensor(x, device=self.device)

    @torch.inference_mode()
    def decode_latents(self, z):
        """Activated decode of latents z (N, D): the tail of both sampling
        paths."""
        recons, _ = self.model.decode(self._tensor(z))
        return activate(recons)

    def warmup(self, buckets=(1, 64)):
        """Run every endpoint once per batch bucket on zero inputs, each
        conditioned on every single modality, so the kernel library is
        built and cuDNN has chosen its algorithms before traffic arrives."""
        spec = self.model.input_spec()

        def zeros(name, n):
            shape, dtype = spec[name]
            return torch.zeros((n,) + tuple(shape), dtype=dtype,
                               device=self.device)

        for m in sorted({_bucket(n) for n in buckets}):
            self.sample(n=m)
            for name in sorted(spec):
                self.sample(n=m, condition={name: zeros(name, 1)})
                self.embed({name: zeros(name, m)})
                self.reconstruct({name: zeros(name, m)})

    @torch.inference_mode()
    def sample(self, n: int = 1, condition: dict = None, seed: int = 0,
               **infer_options):
        """n samples of every modality, from the prior or conditioned on a
        dict of modality arrays with leading batch dim 1. The draw is made
        at the bucket size from a generator seeded with `seed`.
        infer_options: the model's own (celeba19's attrs_mask, the
        attribute experts that join the condition)."""
        m = _bucket(n)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        z = torch.randn((m, self.model.n_latents), generator=gen,
                        device=self.device)
        if condition:
            cond = {k: self._tensor(v) for k, v in condition.items()}
            mu, logvar = self.model.infer(cond, **infer_options)
            z = mu[0] + z * torch.exp(0.5 * logvar[0])
        return {k: v[:n] for k, v in self.decode_latents(z).items()}

    @torch.inference_mode()
    def embed(self, inputs: dict):
        """Fused posterior (mu, logvar) of the given modalities."""
        vals = {k: self._tensor(v) for k, v in inputs.items()}
        n = next(iter(vals.values())).shape[0]
        m = _bucket(n)
        mu, logvar = self.model.infer(
            {k: _pad_rows(v, m) for k, v in vals.items()})
        return mu[:n], logvar[:n]

    @torch.inference_mode()
    def reconstruct(self, inputs: dict):
        """Infer from `inputs`, decode every modality from the posterior
        mean."""
        vals = {k: self._tensor(v) for k, v in inputs.items()}
        n = next(iter(vals.values())).shape[0]
        m = _bucket(n)
        mu, _ = self.model.infer({k: _pad_rows(v, m) for k, v in vals.items()})
        return {k: v[:n] for k, v in self.decode_latents(mu).items()}
