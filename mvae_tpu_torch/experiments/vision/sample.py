"""Vision conditional generation of the port (counterpart of
experiments/vision/sample.py; vision/sample.py:24-136): condition on a
user's image file read as one modality (--condition-type), with the
training data's preprocessing for that modality, or on nothing (the
prior).

    python -m mvae_tpu_torch.experiments.vision.sample model_best.pth.tar \
        [--condition-file face.jpg --condition-type edge] [--device cpu]

The file is resized and center-cropped to 64 and taken as RGB; gray is its
luminance, edge its Canny edges (absolute thresholds, the training data's),
mask one minus its luminance (the training masks are inverted),
obscured its right half zeroed, watermark the mark of --data-dir pasted
over it. Writes samples/sample_{m}.png, an 8-wide grid of --n-samples
(default 1, the reference's) for each of the six modalities, into
--out-dir. The model runs in f32 on the card unless --device says
otherwise; the draws come from a torch.Generator seeded with --seed.
"""

import os

import numpy as np
import torch

from mvae_tpu_torch.data.celeba import _resize_center_crop_64
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.image import transforms as T
from mvae_tpu_torch.models.vision import MODALITIES, VisionMVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.driver import load_model_checkpoint
from mvae_tpu_torch.utils.cli import sample_parser
from mvae_tpu_torch.utils.png import save_image_grid


def load_condition(path, ctype, *, device, data_dir='./data'):
    """A user's file as modality `ctype`: (1, 64, 64, C) f32 on
    `device`."""
    from PIL import Image
    with Image.open(path) as im:
        rgb = np.asarray(_resize_center_crop_64(im.convert('RGB')),
                         np.float32)[None] / 255.0
    x = torch.from_numpy(rgb).to(device)
    if ctype == "image":
        return x
    if ctype == "gray":
        return T.rgb_to_grayscale(x)
    if ctype == "edge":
        return T.canny_edges(x, threshold_mode="absolute")
    if ctype == "mask":
        return 1.0 - T.rgb_to_grayscale(x)   # inverted, as in training
    if ctype == "obscured":
        return T.obscure(x)
    if ctype == "watermark":
        wm = T.load_watermark(64, 64, data_dir=data_dir)
        return T.alpha_composite(x, torch.from_numpy(wm).to(device))
    raise SystemExit(f"unknown condition type {ctype!r}")


def main(argv=None):
    p = sample_parser(condition_file=dict(type=str, default=None),
                      condition_type=dict(type=str, default='image',
                                          choices=list(MODALITIES)))
    p.set_defaults(n_samples=1)             # the reference's one sample
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    model, _ = load_model_checkpoint(args.model_path, VisionMVAE,
                                     device=device)
    cond = None
    if args.condition_file:
        cond = {args.condition_type: load_condition(
            args.condition_file, args.condition_type, device=device,
            data_dir=args.data_dir)}
    out = Sampler(model, device=device).sample(args.n_samples, cond,
                                               seed=args.seed)
    d = os.path.join(args.out_dir, 'samples')
    os.makedirs(d, exist_ok=True)
    for m in MODALITIES:
        img = out[m].float().cpu().numpy()
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        save_image_grid(os.path.join(d, f'sample_{m}.png'), img,
                        nrow=min(8, args.n_samples))
    return out


if __name__ == "__main__":
    main()
