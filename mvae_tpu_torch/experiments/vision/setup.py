"""Vision's offline preprocessing CLI of the port (counterpart of
experiments/vision/setup.py; the reference's vision/setup.py:26-164):

    python -m mvae_tpu_torch.experiments.vision.setup \
        {grayscale,edge,mask} in_dir out_dir [--landmarks lms.npz] \
        [--canny-mode absolute|relative] [--device cpu]

writes one PNG for each .png / .jpg / .jpeg of in_dir: its luminance
(PIL's convert('L')), its Canny edges (sigma 2, skimage's absolute
thresholds by default), or its landmark drawing, dark regions on a white
canvas, from the --landmarks .npz (file name -> (68, 2) xy points; a file
without landmarks gets the white canvas, the reference's fallback for a
failed detection). Grayscale and edge run on the card unless --device
says otherwise; the masks are drawn on the host.
"""

import argparse
import os

import numpy as np
import torch

from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.image import transforms as T
from mvae_tpu_torch.utils.cli import device_flag
from mvae_tpu_torch.utils.png import write_png


def _iter_images(in_dir):
    from PIL import Image
    for name in sorted(os.listdir(in_dir)):
        if name.lower().endswith((".png", ".jpg", ".jpeg")):
            with Image.open(os.path.join(in_dir, name)) as im:
                yield name, im.convert('RGB')


def _rgb(img, device):
    return torch.from_numpy(np.asarray(img, np.float32)[None] / 255.0).to(
        device)


def build_grayscale_dataset(in_dir, out_dir, device):
    for name, img in _iter_images(in_dir):
        g = T.rgb_to_grayscale(_rgb(img, device))[0, ..., 0]
        write_png(os.path.join(out_dir, name), g.cpu().numpy())


def build_edge_dataset(in_dir, out_dir, device, canny_mode='absolute'):
    for name, img in _iter_images(in_dir):
        e = T.canny_edges(_rgb(img, device), sigma=2.0,
                          threshold_mode=canny_mode)[0, ..., 0]
        write_png(os.path.join(out_dir, name), e.cpu().numpy())


def build_mask_dataset(in_dir, out_dir, landmarks_file=None):
    lms = {}
    if landmarks_file:
        with np.load(landmarks_file) as z:
            lms = {k: z[k] for k in z.files}
    for name, img in _iter_images(in_dir):
        w, h = img.size
        write_png(os.path.join(out_dir, name),
                  T.landmark_mask(h, w, lms.get(name))[..., 0])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('type', choices=['grayscale', 'edge', 'mask'])
    p.add_argument('in_dir', type=str)
    p.add_argument('out_dir', type=str)
    p.add_argument('--landmarks', type=str, default=None,
                   help='npz of file name -> (68, 2) landmark points '
                        '(mask only)')
    p.add_argument('--canny-mode', choices=['absolute', 'relative'],
                   default='absolute',
                   help="edge thresholds: 'absolute', skimage's defaults "
                        "(the reference's, vision/setup.py:72); 'relative' "
                        "scales 0.1 / 0.2 by each image's largest gradient")
    device_flag(p)
    args = p.parse_args(argv)
    device = (resolve_device(args.device) if args.type != 'mask'
              else None)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.type == 'grayscale':
        build_grayscale_dataset(args.in_dir, args.out_dir, device)
    elif args.type == 'edge':
        build_edge_dataset(args.in_dir, args.out_dir, device,
                           args.canny_mode)
    else:
        build_mask_dataset(args.in_dir, args.out_dir, args.landmarks)
    print(f"wrote {args.type} variants to {args.out_dir}")


if __name__ == "__main__":
    main()
