"""Dependency-free PNG writer and image-grid assembly (the port's copy of
mvae_tpu/utils/png.py; numpy and zlib only). It takes the place of
torchvision.utils.save_image in the reference's sample.py
(mnist/sample.py:115-118); grayscale and RGB."""

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """img: (H, W) or (H, W, C) uint8 or float in [0,1], C in {1, 3}."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c not in (1, 3):
        raise ValueError(f"unsupported channel count {c}")
    color_type = 0 if c == 1 else 2
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                         0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(out)


def image_grid(images: np.ndarray, nrow: int = 8, pad: int = 2,
               pad_value: float = 0.0) -> np.ndarray:
    """(N, H, W, C) floats -> one grid image, torchvision make_grid layout."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.full((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
                   pad_value, dtype=images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return grid


def save_image_grid(path: str, images, nrow: int = 8):
    write_png(path, image_grid(np.asarray(images), nrow=nrow))
