"""CelebVision: six aligned image modalities of CelebA (the port's copy of
mvae_tpu/data/vision.py).

The reference (vision/datasets.py:19-94) reads the RGB image and
precomputed grayscale, edge and mask variants, computes the obscured and
watermarked images per item, and inverts the mask (1 - mask, :87). Here
gray, edge, obscured and watermark are derived from the RGB rows on the
port's device (image/transforms.py); the landmark mask needs an offline
face detection, so it comes from the precomputed
`img_align_celeba_mask/` directory where there is one, else it is
rasterised on the host from a deterministic synthetic landmark layout
(with the white-canvas fallback), with the same numpy draws as the JAX
package.
"""

import os

import numpy as np
import torch

from mvae_tpu_torch.data.celeba import (
    VALID_PARTITIONS, _resize_center_crop_64, load_celeba,
    load_eval_partition)
from mvae_tpu_torch.data.pipeline import ArrayDataset
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.image import transforms as T

N_MODALITIES = 6
DERIVE_ROWS = 8192      # rows derived at a time (Canny holds about 20
                        # (rows, 64, 64) f32 temporaries: 2.7 GB at this)


def synthetic_landmarks(h=64, w=64, seed=0):
    """A deterministic, plausible 68-point face layout (a jittered
    template)."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((68, 2), np.float32)
    # jaw 0..16: half-ellipse
    t = np.linspace(np.pi, 2 * np.pi, 17)
    pts[0:17, 0] = w / 2 + (w * 0.38) * np.cos(t)
    pts[0:17, 1] = h * 0.45 - (h * 0.42) * np.sin(t)
    # brows 17..26
    for i, x in enumerate(np.linspace(w * 0.25, w * 0.42, 5)):
        pts[17 + i] = (x, h * 0.33)
    for i, x in enumerate(np.linspace(w * 0.58, w * 0.75, 5)):
        pts[22 + i] = (x, h * 0.33)
    # nose 27..35
    for i, y in enumerate(np.linspace(h * 0.38, h * 0.58, 4)):
        pts[27 + i] = (w * 0.5, y)
    for i, x in enumerate(np.linspace(w * 0.44, w * 0.56, 5)):
        pts[31 + i] = (x, h * 0.60)
    # eyes 36..47
    for i, a in enumerate(np.linspace(0, 2 * np.pi, 6, endpoint=False)):
        pts[36 + i] = (w * 0.35 + w * 0.06 * np.cos(a),
                       h * 0.40 + h * 0.03 * np.sin(a))
        pts[42 + i] = (w * 0.65 + w * 0.06 * np.cos(a),
                       h * 0.40 + h * 0.03 * np.sin(a))
    # mouth 48..67
    for i, a in enumerate(np.linspace(0, 2 * np.pi, 20, endpoint=False)):
        pts[48 + i] = (w * 0.5 + w * 0.12 * np.cos(a),
                       h * 0.72 + h * 0.05 * np.sin(a))
    pts += rng.normal(0, 0.8, pts.shape).astype(np.float32)
    return pts


def synthetic_masks(n, h, w, seed):
    """(n, h, w, 1) inverted landmark masks of synthetic faces, about 5%
    of them white-canvas fallbacks (failed detections), from
    np.random.default_rng(seed) as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    mask = np.empty((n, h, w, 1), np.float32)
    for i in range(n):
        lms = None if rng.random() < 0.05 else synthetic_landmarks(
            h, w, seed=int(rng.integers(1 << 31)))
        mask[i] = T.landmark_mask(h, w, lms)
    return 1.0 - mask       # the reference inverts: lines white (:87)


def derive_modalities(rgb: np.ndarray, *, masks: np.ndarray = None,
                      seed: int = 0, data_dir: str = None,
                      canny_mode: str = "absolute", device=None,
                      stats: dict = None) -> dict:
    """rgb: (N, 64, 64, 3) f32 in [0, 1] -> dict of all six modalities,
    host numpy f32. Gray, edge, obscured and watermark run on `device`
    (None: the CUDA card, raises without one; "cpu"), DERIVE_ROWS rows at
    a time; the mask is `masks` (precomputed, already inverted) or
    synthetic_masks(N, ..., seed) on the host.

    canny_mode "absolute" (the default) is skimage.feature.canny's
    threshold semantics, what the reference's offline edge stage made.
    stats: a dict that gets "hysteresis_iters", the fixpoint iterations of
    each chunk."""
    device = resolve_device(device)
    n, h, w, _ = rgb.shape
    # a <data_dir>/watermark.png reproduces the reference's asset
    wm = torch.from_numpy(T.load_watermark(h, w, data_dir=data_dir)).to(
        device)
    parts = {k: [] for k in ("gray", "edge", "obscured", "watermark")}
    iters = []
    for lo in range(0, n, DERIVE_ROWS):
        x = torch.from_numpy(np.ascontiguousarray(
            rgb[lo:lo + DERIVE_ROWS], dtype=np.float32)).to(device)
        edge, k = T.canny_edges(x, threshold_mode=canny_mode,
                                return_iters=True)
        iters.append(k)
        for name, v in (("gray", T.rgb_to_grayscale(x)), ("edge", edge),
                        ("obscured", T.obscure(x)),
                        ("watermark", T.alpha_composite(x, wm))):
            parts[name].append(v.cpu().numpy())
    out = {k: np.concatenate(v) for k, v in parts.items()}
    out["image"] = rgb
    out["mask"] = masks if masks is not None else synthetic_masks(
        n, h, w, seed)
    if stats is not None:
        stats["hysteresis_iters"] = iters
    return out


def _load_precomputed_masks(data_dir, paths):
    """img_align_celeba_mask/<path>, inverted, where the offline set-up
    ran (experiments/vision/setup.py), else None."""
    from PIL import Image
    mask_dir = os.path.join(data_dir, 'img_align_celeba_mask')
    if not os.path.isdir(mask_dir):
        return None
    out = np.empty((len(paths), 64, 64, 1), np.float32)
    for i, p in enumerate(paths):
        with Image.open(os.path.join(mask_dir, p)) as im:
            out[i] = np.asarray(_resize_center_crop_64(im.convert('L')),
                                np.float32)[..., None] / 255.0
    return 1.0 - out      # invert (vision/datasets.py:87)


def load_celeb_vision(data_dir='./data', partition='train', *,
                      synthetic_ok=True, max_examples=None, download=False,
                      device=None, exact_decode=False):
    """The six modalities of a CelebA partition (the real files or the
    synthetic set, data/celeba.py), derived on `device` (None: the CUDA
    card); exact_decode: load_celeba's (PIL for the real images)."""
    base = load_celeba(data_dir, partition, synthetic_ok=synthetic_ok,
                       max_examples=max_examples, download=download,
                       exact_decode=exact_decode)
    masks = None
    if os.path.isfile(os.path.join(data_dir, 'Eval/list_eval_partition.txt')):
        paths = load_eval_partition(partition, data_dir)
        if max_examples:
            paths = paths[:max_examples]
        masks = _load_precomputed_masks(data_dir, paths)
    return ArrayDataset(derive_modalities(
        base.arrays["image"], masks=masks, seed=VALID_PARTITIONS[partition],
        data_dir=data_dir, device=device))
