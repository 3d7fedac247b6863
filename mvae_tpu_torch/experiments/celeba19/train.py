"""CelebA-19 MVAE training CLI of the port (counterpart of
experiments/celeba19/train.py; the reference's flags,
celeba19/train.py:183-204; defaults L=100, batch 100, 100 epochs,
annealing 20, lr 1e-4, lambda image 1 and attrs 10, bf16 compute, --f32
for float32, --approx-m 1).

    python -m mvae_tpu_torch.experiments.celeba19.train [--device cpu] ...

Each step's terms: the complete term, the image-only term, the 18
single-attribute terms, and --approx-m subset terms sampled anew every
step (core/subsets.py; the masks from np.random.default_rng(seed + 1), as
the JAX package draws them); the per-epoch eval is the joint term alone
with lambdas 1 (celeba19/train.py:332-334). Under bf16 the image BCE's
elementwise math runs in bf16 steps (the model's bf16_loss, the JAX
package's MVAE_BF16_LOSS default of this CLI), except with
--fast-term-decode, which decodes the image only for the terms whose
image loss can count (the BN running statistics of the image decoder then
see only those terms). --conv-moments takes the encoder's fused conv + BN
route (the conv2d_moments kernel).
"""

import numpy as np
import torch

from mvae_tpu_torch.core.subsets import (
    celeba19_recon_support, celeba19_static_terms, celeba19_step_terms)
from mvae_tpu_torch.data.celeba import load_celeba
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.celeba19 import N_ATTRS, Celeba19MVAE
from mvae_tpu_torch.parallel.distributed import maybe_initialize
from mvae_tpu_torch.train.driver import run_training
from mvae_tpu_torch.utils.cli import parse_train_args, train_parser

# eval: the joint term only, lambdas 1 (celeba19/train.py:332-334)
EVAL_TERM_MASKS = np.ones((1, 1 + N_ATTRS), np.float32)
EVAL_TERM_LAMBDAS = np.ones((1, 1 + N_ATTRS), np.float32)


def parser():
    p = train_parser(
        n_latents=100, epochs=100, annealing_epochs=20, lr=1e-4,
        lambda_flags=(("lambda-image", 1.0), ("lambda-attrs", 10.0)),
        bf16_default=True)
    p.add_argument('--approx-m', type=int, default=1,
                   help='number of sampled ELBO subset terms [default: 1]')
    p.add_argument('--fast-term-decode', action='store_true', default=False,
                   help='decode the image only for the terms whose image '
                        'loss can count; the image decoder\'s BN running '
                        'statistics then see only those terms (the '
                        'reference decodes every term)')
    p.add_argument('--conv-moments', action='store_true',
                   help='run the encoder\'s BN\'d convs fused, through the '
                        'conv2d_moments kernel')
    return p


def bf16_loss_default(bf16: bool, fast_term_decode: bool) -> bool:
    """The image BCE's bf16 math: on under bf16 compute unless
    --fast-term-decode (experiments/celeba19/train.py:
    apply_bf16_loss_default)."""
    return bf16 and not fast_term_decode


def main(argv=None):
    args = parse_train_args(parser(), argv)
    maybe_initialize(args)         # a rank's process group and card
    device = resolve_device(args.device)
    if not args.bf16:
        # --f32 promises the reference numerics: no TF32 in cuDNN's convs
        torch.backends.cudnn.allow_tf32 = False
    train_ds = load_celeba(args.data_dir, 'train', download=args.download,
                           exact_decode=args.exact_decode)
    test_ds = load_celeba(args.data_dir, 'val',   # the reference evals on val
                          exact_decode=args.exact_decode)
    model = Celeba19MVAE(
        args.n_latents, torch.bfloat16 if args.bf16 else None,
        conv_moments=args.conv_moments,
        bf16_loss=bf16_loss_default(args.bf16, args.fast_term_decode),
        device=device, generator=torch.Generator().manual_seed(args.seed))
    static_m, static_l = celeba19_static_terms(
        N_ATTRS, args.lambda_image, args.lambda_attrs)

    def make_masks(rng):
        return celeba19_step_terms(rng, args.approx_m, N_ATTRS,
                                   args.lambda_image, args.lambda_attrs)

    return run_training(
        model, train_ds, test_ds, args, static_m, static_l,
        out_dir=args.out_dir, device=device,
        meta={"model": "celeba19", "n_latents": args.n_latents},
        make_masks=make_masks, eval_term_masks=EVAL_TERM_MASKS,
        eval_term_lambdas=EVAL_TERM_LAMBDAS,
        recon_support=celeba19_recon_support(args.approx_m, N_ATTRS),
        fast_skip_decode=args.fast_term_decode)


if __name__ == "__main__":
    main()
