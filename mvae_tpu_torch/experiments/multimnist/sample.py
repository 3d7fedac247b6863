"""MultiMNIST conditional generation of the port (counterpart of
experiments/multimnist/sample.py; multimnist/sample.py:65-139): from the
prior, conditioned on a digit string (--condition-on-text 42), on a test
image whose string it is (--condition-on-image 42), or on both.

    python -m mvae_tpu_torch.experiments.multimnist.sample \
        model_best.pth.tar [--condition-on-text 42] [--device cpu]

Writes sample_image.png (an 8-wide grid of the 50x50 images) and
sample_text.txt (each sample's argmax tokens as a string) into --out-dir.
The model runs in f32 on the card unless --device says otherwise; the
draws come from a torch.Generator on the device seeded with --seed.
"""

import os

import numpy as np

from mvae_tpu_torch.data.multimnist import load_multimnist
from mvae_tpu_torch.data.text import decode_tokens, encode_string
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models.multimnist import MultiMnistMVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.driver import load_model_checkpoint
from mvae_tpu_torch.utils.cli import sample_parser
from mvae_tpu_torch.utils.png import save_image_grid


def fetch_image(text, data_dir, seed):
    """A random test image whose digit string is `text`, (1, 50, 50, 1)."""
    ds = load_multimnist(data_dir, train=False)
    match = np.all(ds.arrays["text"] == encode_string(text)[None], axis=1)
    pool = ds.arrays["image"][match]
    if len(pool) == 0:
        raise SystemExit(f"no test image with digit string {text!r}")
    return pool[np.random.default_rng(seed).integers(len(pool))][None]


def main(argv=None):
    args = sample_parser(condition_on_image=dict(type=str, default=None),
                         condition_on_text=dict(type=str, default=None)
                         ).parse_args(argv)
    device = resolve_device(args.device)
    model, _ = load_model_checkpoint(args.model_path, MultiMnistMVAE,
                                     device=device)
    cond = {}
    if args.condition_on_image is not None:
        cond["image"] = fetch_image(args.condition_on_image, args.data_dir,
                                    args.seed)
    if args.condition_on_text is not None:
        cond["text"] = encode_string(args.condition_on_text)[None]
    out = Sampler(model, device=device).sample(args.n_samples, cond,
                                               seed=args.seed)
    tokens = out["text"].argmax(-1).cpu().numpy()           # (N, 4)
    os.makedirs(args.out_dir, exist_ok=True)
    save_image_grid(os.path.join(args.out_dir, 'sample_image.png'),
                    out["image"].cpu().numpy())
    with open(os.path.join(args.out_dir, 'sample_text.txt'), 'w') as fp:
        for i, row in enumerate(tokens):
            fp.write('Text (%d): %s\n' % (i, decode_tokens(row)))
    return out


if __name__ == "__main__":
    main()
