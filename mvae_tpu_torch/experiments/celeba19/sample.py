"""CelebA-19 conditional generation of the port (counterpart of
experiments/celeba19/sample.py): from the prior, conditioned on a test
image that has an attribute (--condition-on-image NAME), on one attribute
(--condition-on-attrs NAME: only that attribute's expert joins the
posterior, celeba19/model.py:63-89), or on both.

    python -m mvae_tpu_torch.experiments.celeba19.sample model_best.pth.tar \
        [--condition-on-attrs Smiling] [--device cpu]

Writes sample_image.png (an 8-wide grid) and sample_attrs.txt (the names
of the attributes each sample has with probability above 0.5) into
--out-dir. The model runs in f32 on the card unless --device says
otherwise; the draws come from a torch.Generator seeded with --seed.
"""

import os

import numpy as np

from mvae_tpu_torch.data.celeba import N_ATTRS, load_celeba
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.experiments.celeba.sample import (
    _attr_index, attributes_to_names)
from mvae_tpu_torch.models.celeba19 import Celeba19MVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.driver import load_model_checkpoint
from mvae_tpu_torch.utils.cli import sample_parser
from mvae_tpu_torch.utils.png import save_image_grid


def main(argv=None):
    args = sample_parser(condition_on_image=dict(type=str, default=None),
                         condition_on_attrs=dict(type=str, default=None)
                         ).parse_args(argv)
    device = resolve_device(args.device)
    model, _ = load_model_checkpoint(args.model_path, Celeba19MVAE,
                                     device=device)
    cond, options = {}, {}
    if args.condition_on_image is not None:
        ds = load_celeba(args.data_dir, 'test')
        ai = _attr_index(args.condition_on_image)
        pool = ds.arrays["image"][ds.arrays["attrs"][:, ai] == 1]
        rng = np.random.default_rng(args.seed)
        cond["image"] = pool[rng.integers(len(pool))][None]
    if args.condition_on_attrs is not None:
        ai = _attr_index(args.condition_on_attrs)
        vec = np.zeros((1, N_ATTRS), np.float32)
        mask = np.zeros(N_ATTRS, np.float32)
        vec[0, ai] = mask[ai] = 1.0
        cond["attrs"], options["attrs_mask"] = vec, mask
    out = Sampler(model, device=device).sample(args.n_samples, cond,
                                               seed=args.seed, **options)
    os.makedirs(args.out_dir, exist_ok=True)
    save_image_grid(os.path.join(args.out_dir, 'sample_image.png'),
                    out["image"].cpu().numpy())
    with open(os.path.join(args.out_dir, 'sample_attrs.txt'), 'w') as fp:
        for row in out["attrs"].cpu().numpy():
            fp.write('%s\n' % ','.join(attributes_to_names(row)))
    return out


if __name__ == "__main__":
    main()
