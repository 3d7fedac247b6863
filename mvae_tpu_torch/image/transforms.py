"""Image transforms of the vision family (counterpart of
mvae_tpu/image/transforms.py), in plain PyTorch on the caller's device:
none of them is a Pallas kernel in the JAX package.

  grayscale: ITU-R 601-2 luminance (PIL's convert('L')), a 3-vector
             contraction.
  canny:     separable Gaussian blur with constant-mode bleed-over
             normalisation (sigma 2, radius int(4 sigma + 0.5)), Sobel,
             skimage's interpolated non-max suppression, a double
             threshold (absolute, skimage's semantics, or relative to each
             image's peak) and hysteresis grown to a fixpoint (one host
             sync an iteration) or for a bounded number of steps. The blur
             and the Sobel are `F.conv2d` (the JAX package's
             `lax.conv_general_dilated`; both are cross-correlations).
  obscure:   zero the columns right of the width midpoint (+1).
  watermark: straight alpha composite of an RGBA mark at (0, 0).
  mask:      landmark-region rasterisation on the host (numpy), from
             precomputed 68-point landmarks, white canvas without them.

Tensors are float32 in [0, 1], NHWC (or HWC for one image).
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

# -- grayscale ---------------------------------------------------------------

LUMA = (0.299, 0.587, 0.114)


def rgb_to_grayscale(img):
    """(..., H, W, 3) -> (..., H, W, 1), PIL convert('L') luminance."""
    luma = torch.tensor(LUMA, dtype=img.dtype, device=img.device)
    return torch.tensordot(img, luma, dims=([-1], [0]))[..., None]


# -- canny -------------------------------------------------------------------

def _gaussian_kernel1d(sigma: float, radius: int):
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return torch.from_numpy(k / k.sum())


def _sep_blur(x, sigma=2.0):
    """Separable Gaussian blur of (B, H, W) with zero padding: along the
    rows (H) first, then the columns (W)."""
    radius = int(4.0 * sigma + 0.5)          # scipy's truncate=4.0
    k = _gaussian_kernel1d(sigma, radius).to(x.device, x.dtype)
    y = F.conv2d(x[:, None], k.view(1, 1, -1, 1), padding=(radius, 0))
    y = F.conv2d(y, k.view(1, 1, 1, -1), padding=(0, radius))
    return y[:, 0]


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _conv3(x, k):
    """3x3 cross-correlation of (B, H, W) with zero padding 1."""
    return F.conv2d(x[:, None], k.view(1, 1, 3, 3), padding=1)[:, 0]


def _interp_nms(mag, gy, gx):
    """skimage's interpolated non-max suppression on (B, H, W).

    The gradient (gy = d/drow, gx = d/dcol) selects one of four octant
    pairs; the magnitude along + and - the gradient is interpolated
    linearly between the two lattice neighbours (w = min|g| / max|g|), and
    a pixel survives where its own magnitude is >= both. Neighbours wrap
    around (`roll`); the border and zero-gradient pixels are masked out.
    Where several octant cases hold, the first listed wins, as
    `jnp.select` decides."""
    ai, aj = gy.abs(), gx.abs()

    def s(dy, dx):   # out[y, x] = mag[y + dy, x + dx]
        return torch.roll(mag, (-dy, -dx), dims=(1, 2))

    m_d, m_u, m_r, m_l = s(1, 0), s(-1, 0), s(0, 1), s(0, -1)
    m_dr, m_ul, m_ur, m_dl = s(1, 1), s(-1, -1), s(-1, 1), s(1, -1)
    one = torch.ones((), dtype=mag.dtype, device=mag.device)
    zero = torch.zeros((), dtype=mag.dtype, device=mag.device)
    w1 = torch.where(ai > 0, aj / torch.where(ai > 0, ai, one), zero)
    w2 = torch.where(aj > 0, ai / torch.where(aj > 0, aj, one), zero)

    def keep(w, c1p, c2p, c1m, c2m):
        return ((c2p * w + c1p * (1.0 - w) <= mag)
                & (c2m * w + c1m * (1.0 - w) <= mag))

    same = ((gy >= 0) & (gx >= 0)) | ((gy <= 0) & (gx <= 0))
    opp = ((gy <= 0) & (gx >= 0)) | ((gy >= 0) & (gx <= 0))
    cases = [
        (opp & (ai >= aj), keep(w1, m_u, m_ur, m_d, m_dl)),    # 135-180
        (opp & (ai <= aj), keep(w2, m_r, m_ur, m_l, m_dl)),    # 90-135
        (same & (ai <= aj), keep(w2, m_r, m_dr, m_l, m_ul)),   # 45-90
        (same & (ai >= aj), keep(w1, m_d, m_dr, m_u, m_ul)),   # 0-45
    ]
    out = torch.zeros_like(mag, dtype=torch.bool)
    for cond, kept in reversed(cases):       # the first true case wins
        out = torch.where(cond, kept, out)
    h, w = mag.shape[1], mag.shape[2]
    rows = torch.arange(h, device=mag.device) % (h - 1) != 0
    cols = torch.arange(w, device=mag.device) % (w - 1) != 0
    return out & (mag > 0) & rows[:, None] & cols[None, :]


def canny_gradients(img, sigma: float = 2.0):
    """(B, H, W, 1|3) -> (mag, gy, gx), each (B, H, W) f32: the blurred
    image's Sobel gradient and its magnitude."""
    if img.shape[-1] == 3:
        img = rgb_to_grayscale(img)
    x = img[..., 0]
    # constant-mode bleed-over normalisation: skimage smooths with cval=0
    # and divides by the blurred all-ones image, so borders stay bright
    g = _sep_blur(x, sigma) / _sep_blur(torch.ones_like(x), sigma)
    sobel = torch.tensor(_SOBEL_X, dtype=g.dtype, device=g.device)
    gx, gy = _conv3(g, sobel), _conv3(g, sobel.T.contiguous())
    return torch.sqrt(gx * gx + gy * gy), gy, gx


def _grow(s, weak):
    """One 8-connected dilation of s into weak (wrapping), s kept."""
    dil = s.clone()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                dil |= torch.roll(s, (dy, dx), dims=(1, 2))
    return (dil & weak) | s


def hysteresis(strong, weak, iters=None):
    """Grow strong edges into weak ones: to a fixpoint (iters None; one
    host sync an iteration, the loop stops when nothing changes) or for
    `iters` steps. Returns (edges bool, iterations run)."""
    if iters is not None:
        for _ in range(iters):
            strong = _grow(strong, weak)
        return strong, iters
    n = 0
    while True:
        n += 1
        grown = _grow(strong, weak)
        if torch.equal(grown, strong):
            return strong, n
        strong = grown


def canny_edges(img, sigma: float = 2.0, low: float = 0.1, high: float = 0.2,
                hysteresis_iters=None, threshold_mode: str = "relative",
                return_iters: bool = False):
    """Batched Canny: img (B, H, W, 1|3) in [0, 1] -> (B, H, W, 1) f32
    edges in {0, 1} (and the hysteresis iterations with return_iters).

    threshold_mode "relative" (the default): low and high are fractions of
    each image's largest gradient among the NMS survivors; "absolute":
    absolute gradient magnitudes, skimage.feature.canny's defaults, the
    semantics of the reference's offline edge stage.
    hysteresis_iters: None grows to a fixpoint (exact 8-connected
    hysteresis); an int bounds the dilation loop."""
    mag, gy, gx = canny_gradients(img, sigma)
    keep = _interp_nms(mag, gy, gx)
    if threshold_mode == "absolute":
        lo_t, hi_t = low, high
    elif threshold_mode == "relative":
        peak = torch.amax(torch.where(keep, mag, torch.zeros_like(mag)),
                          dim=(1, 2), keepdim=True) + 1e-12
        lo_t, hi_t = low * peak, high * peak
    else:
        raise ValueError(f"threshold_mode={threshold_mode!r} "
                         "(want 'relative' or 'absolute')")
    strong = keep & (mag >= hi_t)
    weak = keep & (mag >= lo_t)
    edges, n = hysteresis(strong, weak, hysteresis_iters)
    edges = edges.to(torch.float32)[..., None]
    return (edges, n) if return_iters else edges


# -- obscure / watermark -----------------------------------------------------

def obscure(img):
    """Zero the columns right of the width midpoint (+1), as the
    reference's obscure_image (vision/datasets.py:105-109). img:
    (..., H, W, C)."""
    w = img.shape[-2]
    keep = (torch.arange(w, device=img.device) <= w // 2).to(img.dtype)
    return img * keep[:, None]


def alpha_composite(img, overlay_rgba):
    """Paste an RGBA overlay (H, W, 4) over (..., H, W, 3) at (0, 0), PIL's
    Image.paste(wm, (0, 0), wm)."""
    rgb = overlay_rgba[..., :3]
    a = overlay_rgba[..., 3:4]
    return img * (1.0 - a) + rgb * a


def make_watermark(h: int = 64, w: int = 64) -> np.ndarray:
    """A deterministic procedural RGBA watermark: two translucent diagonal
    bars and a frame (in place of the reference's watermark.png)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    diag1 = np.abs(yy - xx) < h * 0.06
    diag2 = np.abs((h - 1 - yy) - xx) < h * 0.06
    frame = ((yy < 2) | (yy >= h - 2) | (xx < 2) | (xx >= w - 2))
    alpha = np.where(diag1 | diag2, 0.55, 0.0) + np.where(frame, 0.4, 0.0)
    rgba = np.zeros((h, w, 4), np.float32)
    rgba[..., 0] = 0.9   # warm gray mark
    rgba[..., 1] = 0.9
    rgba[..., 2] = 0.9
    rgba[..., 3] = np.clip(alpha, 0.0, 0.8)
    return rgba


def load_watermark(h: int = 64, w: int = 64, *, path: str = None,
                   data_dir: str = None) -> np.ndarray:
    """The RGBA watermark in [0, 1]: the file at `path` (or
    `<data_dir>/watermark.png`), resized bicubic as the reference does
    (vision/datasets.py:114-129), else the procedural mark."""
    if path is None and data_dir is not None:
        cand = os.path.join(data_dir, "watermark.png")
        path = cand if os.path.isfile(cand) else None
    if path is None:
        return make_watermark(h, w)
    from PIL import Image
    im = Image.open(path).convert("RGBA").resize((w, h), Image.BICUBIC)
    return np.asarray(im, np.float32) / 255.0


# -- landmark mask rasterisation (host, numpy) -------------------------------

# the 68-point regions (iBUG 300-W, the reference's FACIAL_LANDMARKS_IDXS)
LANDMARK_REGIONS = {
    "mouth": (48, 68), "right_eyebrow": (17, 22), "left_eyebrow": (22, 27),
    "right_eye": (36, 42), "left_eye": (42, 48), "nose": (27, 36),
    "jaw": (0, 17),
}


def _fill_convex(h, w, pts):
    """Rasterise the convex hull of pts ((N, 2) xy) by half-plane tests."""
    pts = np.asarray(pts, np.float32)
    if len(pts) < 3:
        return np.zeros((h, w), bool)
    hull = _convex_hull(pts)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    inside = np.ones((h, w), bool)
    n = len(hull)
    for i in range(n):
        x1, y1 = hull[i]
        x2, y2 = hull[(i + 1) % n]
        cross = (x2 - x1) * (yy - y1) - (y2 - y1) * (xx - x1)
        inside &= cross >= 0
    return inside


def _convex_hull(pts):
    """Andrew's monotone chain; the hull counter-clockwise."""
    pts = sorted({(float(x), float(y)) for x, y in pts})
    if len(pts) <= 2:
        return list(pts)

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2:
                (x1, y1), (x2, y2) = out[-2], out[-1]
                if (x2 - x1) * (p[1] - y1) - (y2 - y1) * (p[0] - x1) <= 0:
                    out.pop()
                else:
                    break
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return lower[:-1] + upper[:-1]


def _polyline(h, w, pts, thickness=2):
    mask = np.zeros((h, w), bool)
    pts = np.asarray(pts, np.float32)
    for (x1, y1), (x2, y2) in zip(pts[:-1], pts[1:]):
        steps = int(max(abs(x2 - x1), abs(y2 - y1)) * 2 + 1)
        for t in np.linspace(0.0, 1.0, steps):
            cx, cy = x1 + (x2 - x1) * t, y1 + (y2 - y1) * t
            y0 = int(max(cy - thickness, 0))
            y1_ = int(min(cy + thickness + 1, h))
            x0 = int(max(cx - thickness, 0))
            x1_ = int(min(cx + thickness + 1, w))
            mask[y0:y1_, x0:x1_] = True
    return mask


def landmark_mask(h: int, w: int, landmarks=None) -> np.ndarray:
    """The reference's landmark drawing (vision/setup.py:78-146): convex
    fills for the eyes, brows, nose and mouth and a polyline for the jaw,
    dark on a white canvas; the white canvas alone without landmarks.
    landmarks: (68, 2) xy points or None. Returns (h, w, 1) f32."""
    canvas = np.ones((h, w), np.float32)
    if landmarks is None:
        return canvas[..., None]
    landmarks = np.asarray(landmarks, np.float32)
    drawn = np.zeros((h, w), bool)
    for name, (lo, hi) in LANDMARK_REGIONS.items():
        pts = landmarks[lo:hi]
        if name == "jaw":
            drawn |= _polyline(h, w, pts)
        else:
            drawn |= _fill_convex(h, w, pts)
    canvas[drawn] = 0.0
    return canvas[..., None]
