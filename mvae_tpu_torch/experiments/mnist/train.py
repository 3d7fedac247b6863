"""MNIST MVAE training CLI of the port (counterpart of
experiments/mnist/train.py; the reference's flags, mnist/train.py:132-154;
defaults L=64, batch 100, 500 epochs, annealing 200, lr 1e-3, lambda image
1 and text 10, bf16 compute, --f32 for float32).

    python -m mvae_tpu_torch.experiments.mnist.train [--device cpu] ...

Trains on the CUDA card unless --device says otherwise, on the MNIST IDX
files under --data-dir/MNIST/raw or, without them, the synthetic set;
writes checkpoint.pth.tar and model_best.pth.tar into --out-dir. The
per-epoch eval weighs every term's losses by 1, as the reference's test()
does (mnist/train.py:246-248).
"""

import torch

from mvae_tpu_torch.data.mnist import load_mnist
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.mnist import MnistMVAE
from mvae_tpu_torch.train.driver import run_training
from mvae_tpu_torch.utils.cli import parse_train_args, train_parser

# the subset terms: joint, image only, text only (mnist/train.py:200-202)
TERM_MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
EVAL_TERM_LAMBDAS = [[1.0, 1.0]] * 3


def parser():
    return train_parser(n_latents=64, epochs=500, annealing_epochs=200,
                        lr=1e-3, bf16_default=True)


def main(argv=None, *, model_class=MnistMVAE, family="mnist",
         variant="MNIST", flatten=True):
    """The MNIST CLI; the FashionMNIST CLI is this one with its model,
    family name and data variant."""
    args = parse_train_args(parser(), argv)
    device = resolve_device(args.device)
    if not args.bf16:
        # --f32 promises the reference numerics: no TF32 in cuDNN's convs
        torch.backends.cudnn.allow_tf32 = False
    train_ds = load_mnist(args.data_dir, train=True, variant=variant,
                          flatten=flatten, download=args.download)
    test_ds = load_mnist(args.data_dir, train=False, variant=variant,
                         flatten=flatten, download=args.download)
    model = model_class(args.n_latents,
                        torch.bfloat16 if args.bf16 else None, device=device,
                        generator=torch.Generator().manual_seed(args.seed))
    lambdas = [[args.lambda_image, args.lambda_text]] * 3
    return run_training(model, train_ds, test_ds, args, TERM_MASKS, lambdas,
                        out_dir=args.out_dir,
                        eval_term_lambdas=EVAL_TERM_LAMBDAS, device=device,
                        meta={"model": family, "n_latents": args.n_latents})


if __name__ == "__main__":
    main()
