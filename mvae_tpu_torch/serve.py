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
otherwise; images NHWC. `warmup` runs every endpoint at the batch buckets
a server will see, conditioned on the modality sets of `conditions=`.

The HTTP front (serve_http.py) serves these endpoints over the network,
coalescing concurrent /embed and /reconstruct requests into one call.

Serving over a data-parallel group (`Sampler(model, dp=...)`, a
parallel.mesh.DataParallel: the counterpart of the JAX Sampler's mesh=,
mvae_tpu/serve.py:60-80, 135-141): the parameters stay replicated, every
rank calls each endpoint with the same request, the bucket rounds up to a
multiple of the group's size, each rank computes its rows of the padded
batch (the prior's noise is drawn at the global shape from the seed and
each rank keeps its rows; a condition's posterior is every rank's), and
the results are all-gathered, so every rank returns one device's values.
"""

import torch

from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models import model_ctor
from mvae_tpu_torch.parallel.collectives import gather_rows
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
    def __init__(self, model, *, device=None, dp=None):
        """model: an eval-mode model on `device` (None: the CUDA card,
        raises without one; "cpu": the CPU). dp: a DataParallel group to
        serve over (see the module docstring), or None."""
        device = resolve_device(device)
        if model.device != device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"sampler was asked to serve on {device}")
        self.model = model.eval()
        self.device = device
        self.dp = dp if dp is not None and dp.world > 1 else None

    def _bucket_m(self, n: int) -> int:
        """The batch bucket: the next power of two, rounded up to a
        multiple of the group's size (equal rows a rank)."""
        m = _bucket(n)
        if self.dp is not None:
            m = -(-m // self.dp.world) * self.dp.world
        return m

    def _mine(self, x):
        """This rank's rows of a padded batch."""
        if self.dp is None:
            return x
        b = x.shape[0] // self.dp.world
        return x[self.dp.rank * b:(self.dp.rank + 1) * b]

    def _joined(self, tree):
        """The group's rows of each tensor of a dict or tuple, in rank
        order."""
        if self.dp is None:
            return tree
        if isinstance(tree, dict):
            return {k: gather_rows(self.dp.group, v) for k, v in tree.items()}
        return tuple(gather_rows(self.dp.group, v) for v in tree)

    @classmethod
    def from_checkpoint(cls, path, *, device=None, compute_dtype=None,
                        family=None, dp=None):
        """Serve a reference-layout `.pth.tar` of a ported family: the
        port's own checkpoints, which name it, and those of the JAX
        package's utils/torch_export.py:export_checkpoint or the
        reference, whose keys tell it (utils/weights.py:
        checkpoint_family). family: the family the caller expects; a
        checkpoint of another raises ValueError. dp: as __init__'s."""
        device = resolve_device(device)
        sd, meta = load_reference_checkpoint(path, device=device)
        found = checkpoint_family(sd, meta)
        if family is not None and family != found:
            raise ValueError(f"{path} holds a {found} model, not {family}")
        model = model_ctor(found)(
            meta["n_latents"], compute_dtype, device=device)
        model.load_state_dict(sd, strict=True)
        return cls(model, device=device, dp=dp)

    def _tensor(self, x):
        return torch.as_tensor(x, device=self.device)

    @torch.inference_mode()
    def decode_latents(self, z):
        """Activated decode of latents z (N, D): the tail of both sampling
        paths."""
        recons, _ = self.model.decode(self._tensor(z))
        return activate(recons)

    def warmup(self, buckets=(1, 64), conditions=None):
        """Run every endpoint once per batch bucket on zero inputs, so the
        kernel library is built and cuDNN has chosen its algorithms before
        traffic arrives: the prior sample, and for each modality set of
        `conditions` (tuples of names; default: each single modality) the
        conditioned sample, embed and reconstruct. The HTTP front
        (serve_http.py:main) warms the buckets its coalesced batches
        reach."""
        spec = self.model.input_spec()
        if conditions is None:
            conditions = [(k,) for k in sorted(spec)]

        def zeros(name, n):
            shape, dtype = spec[name]
            return torch.zeros((n,) + tuple(shape), dtype=dtype,
                               device=self.device)

        for m in sorted({self._bucket_m(n) for n in buckets}):
            self.sample(n=m)
            for names in conditions:
                self.sample(n=m, condition={k: zeros(k, 1) for k in names})
                self.embed({k: zeros(k, m) for k in names})
                self.reconstruct({k: zeros(k, m) for k in names})

    @torch.inference_mode()
    def sample(self, n: int = 1, condition: dict = None, seed: int = 0,
               **infer_options):
        """n samples of every modality, from the prior or conditioned on a
        dict of modality arrays with leading batch dim 1. The draw is made
        at the bucket size from a generator seeded with `seed`.
        infer_options: the model's own (celeba19's attrs_mask, the
        attribute experts that join the condition)."""
        m = self._bucket_m(n)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        z = self._mine(torch.randn((m, self.model.n_latents), generator=gen,
                                   device=self.device))
        if condition:
            cond = {k: self._tensor(v) for k, v in condition.items()}
            mu, logvar = self.model.infer(cond, **infer_options)
            z = mu[0] + z * torch.exp(0.5 * logvar[0])
        out = self._joined(self.decode_latents(z))
        return {k: v[:n] for k, v in out.items()}

    @torch.inference_mode()
    def embed(self, inputs: dict):
        """Fused posterior (mu, logvar) of the given modalities."""
        vals = {k: self._tensor(v) for k, v in inputs.items()}
        n = next(iter(vals.values())).shape[0]
        m = self._bucket_m(n)
        mu, logvar = self._joined(self.model.infer(
            {k: self._mine(_pad_rows(v, m)) for k, v in vals.items()}))
        return mu[:n], logvar[:n]

    @torch.inference_mode()
    def reconstruct(self, inputs: dict):
        """Infer from `inputs`, decode every modality from the posterior
        mean."""
        vals = {k: self._tensor(v) for k, v in inputs.items()}
        n = next(iter(vals.values())).shape[0]
        m = self._bucket_m(n)
        mu, _ = self.model.infer(
            {k: self._mine(_pad_rows(v, m)) for k, v in vals.items()})
        out = self._joined(self.decode_latents(mu))
        return {k: v[:n] for k, v in out.items()}
