"""Importance-sampled log-likelihood CLI body (counterpart of
mvae_tpu/train/loglike_cli.py, the reference's promised loglike.py,
README.md:36). Each family's loglike CLI wires in its model class and
test-set loader:

    python -m mvae_tpu_torch.experiments.mnist.loglike model_best.pth.tar \
        [--target image|text|joint] [--n-samples K] [--device cpu]

The proposal q conditions on every modality; the estimate is the mean of
core/loglike.py:iwae_log_marginal over the test set, every example
counted (no ragged tail dropped), in the batch order of the file. The
draws come from a torch.Generator on the device seeded with --seed.
"""

import argparse

import numpy as np
import torch

from mvae_tpu_torch.core.loglike import iwae_log_marginal
from mvae_tpu_torch.data.pipeline import batches
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.train.driver import load_model_checkpoint
from mvae_tpu_torch.utils.cli import device_flag


def run_loglike(argv, model_ctor, load_test_ds):
    """Parse argv, estimate, print the reference's line
    `====> log p(<target>) >= <v>  (K=..., N=...)` and return the
    estimate."""
    p = argparse.ArgumentParser()
    p.add_argument('model_path', type=str)
    p.add_argument('--n-samples', type=int, default=100,
                   help='importance samples K per example [default: 100]')
    p.add_argument('--batch-size', type=int, default=100)
    p.add_argument('--max-examples', type=int, default=None)
    p.add_argument('--target', type=str, default='image',
                   help='modality (or "joint") whose marginal to estimate')
    device_flag(p)
    p.add_argument('--data-dir', type=str, default='./data')
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    # the estimate is a reported metric: the model's f32 numerics, no TF32
    # in cuDNN's convolutions (cuBLAS keeps TF32 off by default)
    torch.backends.cudnn.allow_tf32 = False
    model, _ = load_model_checkpoint(args.model_path, model_ctor,
                                     device=device)
    # the inputs whose losses log p(x|z) sums: the modalities, or the
    # model's loglike_targets (celeba19's image and attrs inputs)
    names = tuple(getattr(model, "loglike_targets", model.modalities))
    if args.target not in names + ("joint",):
        p.error(f"--target must be one of {names + ('joint',)}")
    targets = list(names) if args.target == "joint" else [args.target]
    proposal = [1.0] * len(model.modalities)
    test_ds = load_test_ds(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    vals, seen = [], 0
    for batch in batches(test_ds, args.batch_size, shuffle=False):
        if args.max_examples and seen >= args.max_examples:
            break
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        vals.append(iwae_log_marginal(model, batch, proposal, targets,
                                      args.n_samples, generator=gen).cpu())
        seen += len(vals[-1])
    ll = float(np.mean(torch.cat(vals).numpy()))
    print('====> log p({}) >= {:.4f}  (K={}, N={})'.format(
        args.target, ll, args.n_samples, seen))
    return ll
