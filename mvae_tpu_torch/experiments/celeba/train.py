"""CelebA MVAE training CLI of the port (counterpart of
experiments/celeba/train.py; the reference's flags, celeba/train.py:
121-138; defaults L=100, batch 100, 100 epochs, annealing 20, lr 1e-4,
lambda image 1 and attrs 10, bf16 compute, --f32 for float32).

    python -m mvae_tpu_torch.experiments.celeba.train [--device cpu] ...

Trains on the CUDA card unless --device says otherwise, on the real
CelebA files under --data-dir or, without them, the synthetic set; writes
checkpoint.pth.tar and model_best.pth.tar into --out-dir. --conv-moments
takes the encoder's fused conv + BN route (the conv2d_moments kernel; the
JAX package's opt-in MVAE_CONVBN_PALLAS=1).
"""

import torch

from mvae_tpu_torch.data.celeba import load_celeba
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.parallel.distributed import maybe_initialize
from mvae_tpu_torch.train.driver import run_training
from mvae_tpu_torch.utils.cli import parse_train_args, train_parser

TERM_MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]


def parser():
    p = train_parser(
        n_latents=100, epochs=100, annealing_epochs=20, lr=1e-4,
        lambda_flags=(("lambda-image", 1.0), ("lambda-attrs", 10.0)),
        bf16_default=True)
    p.add_argument('--conv-moments', action='store_true',
                   help='run the encoder\'s BN\'d convs fused, through the '
                        'conv2d_moments kernel, instead of a conv and then '
                        'the BN kernels')
    return p


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
    model = CelebaMVAE(args.n_latents,
                       torch.bfloat16 if args.bf16 else None,
                       conv_moments=args.conv_moments, device=device,
                       generator=torch.Generator().manual_seed(args.seed))
    lambdas = [[args.lambda_image, args.lambda_attrs]] * 3
    return run_training(model, train_ds, test_ds, args, TERM_MASKS, lambdas,
                        out_dir=args.out_dir, device=device,
                        meta={"model": "celeba", "n_latents": args.n_latents})


if __name__ == "__main__":
    main()
