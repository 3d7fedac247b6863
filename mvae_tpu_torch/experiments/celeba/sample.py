"""CelebA conditional generation of the port (counterpart of
experiments/celeba/sample.py; celeba/sample.py:63-139): condition on an
attribute name, through an image of the test set that has it
(--condition-on-image NAME) or through the attribute vector
(--condition-on-attrs NAME, also spelt --condition-on-text, the
reference parser's name), on both, or on nothing (the prior).

    python -m mvae_tpu_torch.experiments.celeba.sample model_best.pth.tar \
        [--condition-on-attrs Smiling] [--device cpu]

Writes sample_image.png (an 8-wide grid) and sample_attrs.txt (the names
of the attributes each sample has with probability above 0.5) into
--out-dir. The model runs in f32 on the card unless --device says
otherwise; the draws come from a torch.Generator seeded with --seed.
"""

import os

import numpy as np

from mvae_tpu_torch.data.celeba import (
    ATTR_IX_TO_KEEP, ATTR_TO_IX_DICT, IX_TO_ATTR_DICT, N_ATTRS, load_celeba)
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.driver import load_model_checkpoint
from mvae_tpu_torch.utils.cli import sample_parser
from mvae_tpu_torch.utils.png import save_image_grid


def _attr_index(attr_name):
    if attr_name not in ATTR_TO_IX_DICT:
        raise SystemExit(f"unknown attribute {attr_name!r}; "
                         f"choose from {sorted(ATTR_TO_IX_DICT)}")
    ix = ATTR_TO_IX_DICT[attr_name]
    if ix not in ATTR_IX_TO_KEEP:
        raise SystemExit(f"{attr_name!r} is not one of the 18 kept attributes")
    return ATTR_IX_TO_KEEP.index(ix)


def attributes_to_names(vec):
    """The names of the attributes a sigmoid vector holds above 0.5
    (reference tensor_to_attributes, celeba/datasets.py:138-152)."""
    return [IX_TO_ATTR_DICT[ATTR_IX_TO_KEEP[i]]
            for i, v in enumerate(np.asarray(vec)) if v > 0.5]


def main(argv=None):
    p = sample_parser(condition_on_image=dict(type=str, default=None),
                      condition_on_attrs=dict(type=str, default=None),
                      condition_on_text=dict(
                          type=str, default=None,
                          help='alias of --condition-on-attrs'))
    args = p.parse_args(argv)
    if args.condition_on_attrs is None:
        args.condition_on_attrs = args.condition_on_text
    device = resolve_device(args.device)
    model, _ = load_model_checkpoint(args.model_path, CelebaMVAE,
                                     device=device)
    cond = {}
    if args.condition_on_image is not None:
        ds = load_celeba(args.data_dir, 'test')
        ai = _attr_index(args.condition_on_image)
        pool = ds.arrays["image"][ds.arrays["attrs"][:, ai] == 1]
        rng = np.random.default_rng(args.seed)
        cond["image"] = pool[rng.integers(len(pool))][None]
    if args.condition_on_attrs is not None:
        vec = np.zeros((1, N_ATTRS), np.float32)
        vec[0, _attr_index(args.condition_on_attrs)] = 1.0
        cond["attrs"] = vec
    out = Sampler(model, device=device).sample(args.n_samples, cond,
                                               seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    save_image_grid(os.path.join(args.out_dir, 'sample_image.png'),
                    out["image"].cpu().numpy())
    with open(os.path.join(args.out_dir, 'sample_attrs.txt'), 'w') as fp:
        for row in out["attrs"].cpu().numpy():
            fp.write('%s\n' % ','.join(attributes_to_names(row)))
    return out


if __name__ == "__main__":
    main()
