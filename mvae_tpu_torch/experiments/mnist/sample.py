"""MNIST conditional generation of the port (counterpart of
experiments/mnist/sample.py): the reference's four modes
(mnist/sample.py:48-122) — from the prior, conditioned on an image of a
digit (--condition-on-image D), on a label (--condition-on-text D), or on
both — with the JAX package's fixes (label 0 is honoured; the
conditioning image is a [0, 1] test-set row).

    python -m mvae_tpu_torch.experiments.mnist.sample model_best.pth.tar \
        [--condition-on-text 3] [--device cpu]

Writes sample_image.png (an 8-wide grid) and sample_text.txt (the argmax
label of each sample) into --out-dir. The model runs in f32 on the card
unless --device says otherwise; the draws come from a torch.Generator on
the device seeded with --seed (serve.py:Sampler.sample).
"""

import os

import numpy as np

from mvae_tpu_torch.data.mnist import load_mnist
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.mnist import MnistMVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.driver import load_model_checkpoint
from mvae_tpu_torch.utils.cli import sample_parser
from mvae_tpu_torch.utils.png import save_image_grid


def main(argv=None, *, model_class=MnistMVAE, variant="MNIST",
         flatten=True):
    """The MNIST CLI; the FashionMNIST CLI is this one with its model and
    data variant."""
    args = sample_parser(condition_on_image=dict(type=int, default=None),
                         condition_on_text=dict(type=int, default=None)
                         ).parse_args(argv)
    device = resolve_device(args.device)
    model, _ = load_model_checkpoint(args.model_path, model_class,
                                     device=device)
    cond = {}
    if args.condition_on_image is not None:
        ds = load_mnist(args.data_dir, train=False, variant=variant,
                        flatten=flatten)
        pool = ds.arrays["image"][ds.arrays["text"] == args.condition_on_image]
        rng = np.random.default_rng(args.seed)
        cond["image"] = pool[rng.integers(len(pool))][None]
    if args.condition_on_text is not None:
        cond["text"] = np.asarray([args.condition_on_text], np.int32)
    out = Sampler(model, device=device).sample(args.n_samples, cond,
                                               seed=args.seed)
    images = out["image"].reshape(-1, 28, 28, 1).cpu().numpy()
    texts = out["text"].argmax(-1).tolist()
    os.makedirs(args.out_dir, exist_ok=True)
    save_image_grid(os.path.join(args.out_dir, 'sample_image.png'), images)
    with open(os.path.join(args.out_dir, 'sample_text.txt'), 'w') as fp:
        for i, item in enumerate(texts):
            fp.write('Text (%d): %s\n' % (i, item))
    return out


if __name__ == "__main__":
    main()
