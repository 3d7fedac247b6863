"""MultiMNIST: 0-4 MNIST digits composited on a 50x50 canvas (the port's
copy of the numpy generator of mvae_tpu/data/multimnist.py; reference
multimnist/datasets.py:107-342).

Per example, k ~ U{min_digits..max_digits} digits, each shrunk to side
int(28 / s) with s ~ N(1.3, 0.1) by a bilinear resize (the reference's
scipy.misc.imresize, removed from scipy) and placed at a random offset in
[0, 50 - side - 1] (or centred without translation). The digits are
summed; a canvas with a pixel above 255 is redrawn whole. The fixed
variant puts digits of side 21 on four fixed pads; `reverse`, `scramble`
and `no_repeat` act on the label string. Generation is deterministic from
np.random.default_rng(681307), so the port writes the same shards as the
JAX package's numpy path (`make_dataset(..., use_native=False)`). The JAX
package's native C++ compositor is not ported: it draws from another RNG,
and the numpy path takes long for the 60k/10k canonical sizes.

Shards: <root>/multimnist/{training,test}.npz with `images` (N, 50, 50)
uint8 and `texts` (N, 4) int32, the JAX package's layout: each side reads
the other's. Loaded images are float32 in [0, 1], (N, 50, 50, 1).
"""

import os

import numpy as np

from mvae_tpu_torch.data.download import DownloadError, download_idx
from mvae_tpu_torch.data.mnist import load_mnist
from mvae_tpu_torch.data.pipeline import ArrayDataset
from mvae_tpu_torch.data.text import MAX_LENGTH, encode_digit_list

SEED = 681307
FIXED_PADS = [(4, 4), (4, 23), (23, 4), (23, 23)]
CANVAS = 50


def bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize, align_corners=False."""
    in_h, in_w = img.shape
    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def resized_side(s: float) -> int:
    """imresize(img, 1/s)'s output side: int(28 / s), clamped to the canvas
    for the vanishing tail of the scale distribution."""
    if s <= 0:
        return 1
    return int(np.clip(int(28.0 / s), 1, CANVAS))


def _sample_one(digits_pool, labels_pool, rng, *, resize, translate):
    """One shrunk digit and its place on the canvas (:107-129)."""
    i = int(rng.integers(0, len(digits_pool)))
    d = digits_pool[i].astype(np.float32)
    if resize:
        side = resized_side(0.1 * rng.normal() + 1.3)
        d = bilinear_resize(d, side, side)
    h = d.shape[0]
    padding = CANVAS - h
    if translate and padding > 0:
        # randint(0, padding) excludes padding (:120-122)
        top = int(rng.integers(0, padding))
        left = int(rng.integers(0, padding))
    else:
        top = left = padding // 2
    return d, top, left, int(labels_pool[i])


def sample_multi(digits_pool, labels_pool, k, rng, *, resize, translate,
                 max_tries=10000):
    """Compose k digits; a canvas whose summed maximum exceeds 255 is
    redrawn whole, identities included (:141-146). max_tries guards
    configurations where the reference would recurse forever."""
    for _ in range(max_tries):
        canvas = np.zeros((CANVAS, CANVAS), np.float32)
        labels = []
        for _ in range(k):
            d, top, left, lab = _sample_one(
                digits_pool, labels_pool, rng,
                resize=resize, translate=translate)
            h, w = d.shape
            canvas[top:top + h, left:left + w] += d
            labels.append(lab)
        if canvas.max() <= 255.0:
            return canvas, labels
    raise RuntimeError(
        f"multimnist: no non-overlapping canvas with k={k} digits after "
        f"{max_tries} tries")


def sample_multi_fixed(digits_pool, labels_pool, k, rng, *, resize,
                       scramble, reverse, no_repeat, max_tries=10000):
    """The fixed-pad variant (:220-250): scale 1.3 on the pads in slot
    order; reverse flips the label string with probability 0.5, scramble
    shuffles it, no_repeat redraws a digit until its label is new; the
    same rejection of canvases above 255."""
    del resize  # the reference always resizes in fixed mode
    side = resized_side(1.3)
    for _ in range(max_tries):
        canvas = np.zeros((CANVAS, CANVAS), np.float32)
        labels = []
        for slot in range(k):
            while True:
                i = int(rng.integers(0, len(digits_pool)))
                lab = int(labels_pool[i])
                if not (no_repeat and lab in labels):
                    break
            d = bilinear_resize(digits_pool[i].astype(np.float32),
                                side, side)
            top, left = FIXED_PADS[slot]
            canvas[top:top + side, left:left + side] += d
            labels.append(lab)
        if reverse and rng.random() > 0.5:
            labels = labels[::-1]
        if scramble:
            rng.shuffle(labels)
        if canvas.max() <= 255.0:
            return canvas, labels
    raise RuntimeError(
        f"multimnist fixed: no non-overlapping canvas with k={k} digits "
        f"after {max_tries} tries")


def mk_dataset(n, digits_pool, labels_pool, rng, *, min_digits=0,
               max_digits=4, resize=True, translate=True, fixed=False,
               scramble=False, reverse=False, no_repeat=False):
    images = np.zeros((n, CANVAS, CANVAS), np.uint8)
    texts = np.zeros((n, MAX_LENGTH), np.int32)
    for i in range(n):
        k = int(rng.integers(min_digits, max_digits + 1))
        if fixed:
            canvas, labels = sample_multi_fixed(
                digits_pool, labels_pool, k, rng, resize=resize,
                scramble=scramble, reverse=reverse, no_repeat=no_repeat)
        else:
            canvas, labels = sample_multi(
                digits_pool, labels_pool, k, rng, resize=resize,
                translate=translate)
        images[i] = canvas.astype(np.uint8)    # accepted: max <= 255
        texts[i] = encode_digit_list(labels)
    return images, texts


def make_dataset(root="./data", *, n_train=60000, n_test=10000, **opts):
    """Generate both splits from the MNIST digits under root (the IDX files
    or the synthetic fallback) and write the shards; returns their
    directory. opts: mk_dataset's options."""
    out_dir = os.path.join(root, "multimnist")
    os.makedirs(out_dir, exist_ok=True)
    for split, n in (("training", n_train), ("test", n_test)):
        src = load_mnist(root, train=(split == "training"), flatten=False)
        digits = src.arrays["image"].reshape(-1, 28, 28) * 255.0
        rng = np.random.default_rng(SEED)
        images, texts = mk_dataset(n, digits, src.arrays["text"], rng,
                                   **opts)
        np.savez_compressed(os.path.join(out_dir, f"{split}.npz"),
                            images=images, texts=texts)
    return out_dir


def load_multimnist(root="./data", train=True, *, generate_n=None,
                    download=False):
    """Load a split's shard; without one, generate a small set first
    (generate_n training rows, default 2000, and a fifth as many test
    rows, at least 200). download=True fetches the source MNIST archives
    first where the shard is missing (data/download.py), so that the
    generator composites real digits; where that fails it prints why and
    generates from the local or synthetic MNIST."""
    split = "training" if train else "test"
    path = os.path.join(root, "multimnist", f"{split}.npz")
    if download and not os.path.exists(path):
        try:
            download_idx(root, "MNIST")
        except (DownloadError, OSError) as e:
            print(f"[mvae_tpu_torch] --download failed ({e}); generating "
                  "from local/synthetic MNIST instead")
    if not os.path.exists(path):
        n_train = generate_n or 2000
        print(f"[mvae_tpu_torch.data] MultiMNIST: no shards at {path!r} — "
              f"generating {n_train} train examples now (run "
              f"mvae_tpu_torch.experiments.multimnist.datasets for more)")
        make_dataset(root, n_train=n_train, n_test=max(n_train // 5, 200))
    with np.load(path) as z:
        images = z["images"].astype(np.float32)[..., None] / 255.0
        texts = z["texts"].astype(np.int32)
    return ArrayDataset({"image": images, "text": texts})
