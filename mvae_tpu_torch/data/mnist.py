"""MNIST / FashionMNIST loading (the port's copy of mvae_tpu/data/mnist.py).

The standard IDX files (plain or .gz) are read from `<root>/MNIST/raw` (or
`<root>/FashionMNIST/raw`); without them a deterministic synthetic set of
the same shapes and dtypes stands in, bit-identical to the JAX package's.
`download=True` first fetches the four archives (data/download.py; it
needs network access); where that fails it prints why and goes on with
the files it finds or the synthetic set.

Images are float32 in [0, 1], (N, 784) flattened or (N, 28, 28, 1);
labels int32 (N,).
"""

import gzip
import os
import struct

import numpy as np

from mvae_tpu_torch.data.download import DownloadError, download_idx
from mvae_tpu_torch.data.pipeline import ArrayDataset, warn_synthetic

_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def write_idx(path, array):
    """Write a uint8 array as an IDX file (gzip if path ends in .gz): the
    format _read_idx reads, for test sets made from the synthetic data."""
    a = np.ascontiguousarray(array, dtype=np.uint8)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | a.ndim))
        f.write(struct.pack(">" + "I" * a.ndim, *a.shape))
        f.write(a.tobytes())


def _find(raw_dir, stem):
    for suffix in ("", ".gz"):
        p = os.path.join(raw_dir, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def load_mnist(root="./data", train=True, *, variant="MNIST",
               flatten=True, synthetic_ok=True, download=False):
    if download:
        try:
            download_idx(root, variant)
        except (DownloadError, OSError) as e:
            print(f"[mvae_tpu_torch] --download failed ({e}); falling back "
                  "to local files / synthetic data")
    raw = os.path.join(root, variant, "raw")
    img_stem, lab_stem = _FILES[train]
    ip, lp = _find(raw, img_stem), _find(raw, lab_stem)
    if ip and lp:
        images = _read_idx(ip).astype(np.float32) / 255.0
        labels = _read_idx(lp).astype(np.int32)
    elif synthetic_ok:
        warn_synthetic(variant, raw)
        images, labels = synthetic_mnist(60000 if train else 10000,
                                         seed=0 if train else 1)
    else:
        raise FileNotFoundError(f"no {variant} IDX files under {raw}")
    if flatten:
        images = images.reshape(len(images), 784)
    else:
        images = images.reshape(len(images), 28, 28, 1)
    return ArrayDataset({"image": images, "text": labels})


def synthetic_mnist(n, seed=0, size=28):
    """Class-structured synthetic digits with MNIST-like ink statistics:
    sparse bright strokes on a black background, one smooth stroke
    template per class plus per-sample amplitude and noise jitter.
    Deterministic."""
    rng = np.random.default_rng(seed)
    templates = rng.random((10, size, size)).astype(np.float32)
    # cheap separable smoothing for spatial correlation
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for _ in range(4):
        templates = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), 1, templates)
        templates = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), 2, templates)
    # keep only the brightest ridge of the field -> stroke-like sparsity
    thresh = np.quantile(templates, 0.82, axis=(1, 2), keepdims=True)
    templates = np.clip((templates - thresh) * 12.0, 0.0, 1.0)
    # digits live mostly in the center of the tile, like MNIST
    ax = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    win = np.exp(-2.0 * (ax[None, :] ** 2 + ax[:, None] ** 2))
    templates *= np.clip(win * 1.6, 0.0, 1.0)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    ink = templates[labels]
    amp = rng.uniform(0.75, 1.0, (n, 1, 1)).astype(np.float32)
    noise = rng.normal(0, 0.08, (n, size, size)).astype(np.float32)
    images = np.clip(ink * amp + noise * (ink > 0.02), 0.0, 1.0)
    return images, labels
