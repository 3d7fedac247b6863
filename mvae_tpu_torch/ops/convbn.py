"""Bias-free conv2d with the per-channel moments of its output: the CUDA
kernel of csrc/conv_moments.cu, its plain PyTorch version, and the autograd.

Counterpart of mvae_tpu/ops/convbn_pallas.py:conv2d_moments, in the port's
layout: x is NCHW (B, C_in, H, W) and w OIHW (C_out, C_in, k, k), what
nn/conv.py:Conv2d holds, and y comes back NCHW; the JAX function takes NHWC
x and HWIO w and returns NHWC y. The sums are the same either way:

    y = conv2d(x, w)                   in x's dtype, no bias
    s = sum of y over (B, OH, OW)      (C_out,) f32, of the ROUNDED y
    q = sum of y * y over the same     (C_out,) f32

the two batch-moment sums a train-mode BatchNorm of y needs
(nn/norm.py:bn_swish_from_moments), taken where y is made.

Shapes: the 4x4 convolutions of the DCGAN stacks, stride 2 with padding 1
(even H and W) and stride 1 with padding 0 (`supported`, convbn_pallas.py:
61-71). The backward folds the three cotangents into one, dy = gy + gs +
2 y gq in f32, rounded to y's dtype, and runs the stock convolution
backward on it (convbn_pallas.py:_vjp_bwd): the JAX package leaves that
backward to XLA's convolution, outside any Pallas kernel, so there is no
backward kernel to port.

y comes back as its rounded values in f32: its one caller, the BN from
the sums, reads y in f32 anyway, and y's cotangent then reaches the fold
in f32, so the fold rounds once. In bf16 that matters: the BN's gradient
through y and through the sums nearly cancel, and a gy rounded to bf16
before they do (as JAX's transpose of y.astype(f32) rounds it) leaves the
gradients of the convs below several times as far from the f32 step's as
the unfused route's BN does, whose dx cancels in f32 and rounds once.
`y.to(x.dtype)` gives y in x's dtype exactly.
"""

import functools

import torch
from torch.nn import functional as F

from mvae_tpu_torch.ops import _cuda
from mvae_tpu_torch.ops._cuda import SM_COUNT

KERNEL = 4
TILE_M = 64         # output pixels a block: the M of one wgmma
STAGES = 4          # depth of the kernel's ring of K slices
SLICE_BYTES = 128   # a weight row of one K slice (the swizzle's width)
F32_TILE_N = 64
MAX_SMEM = 232448   # dynamic shared memory a block can have
_DTYPES = (torch.float32, torch.bfloat16)
# launch_geometry's entries that csrc/conv_moments.cu takes, in its order
_GEOMETRY_ARGS = ("tiles", "tile_m", "bn", "atoms", "stages", "rs", "ch", "lp",
                  "vec", "a_stage", "smem")


def supported(x_shape, k: int, stride: int, padding: int) -> bool:
    """The shapes the op takes, x NCHW: 4x4 stride 2 padding 1 on an even
    map, 4x4 stride 1 padding 0 on a map of at least 4x4."""
    if len(x_shape) != 4:
        return False
    _, _, h, w = x_shape
    if k == KERNEL and stride == 2 and padding == 1:
        return h % 2 == 0 and w % 2 == 0
    if k == KERNEL and stride == 1 and padding == 0:
        return h >= k and w >= k
    return False


def out_hw(n: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - KERNEL) // stride + 1


@functools.lru_cache(maxsize=None)
def launch_geometry(b: int, c_in: int, h: int, w: int, c_out: int,
                    stride: int, padding: int, itemsize: int) -> dict:
    """How the kernel is launched on a supported shape, everything
    csrc/conv_moments.cu is told beyond the tensors' sizes.

    A block owns `tile_m` consecutive output pixels by `bn` channels (grid
    `tiles` x `n_tiles`) and walks K in stages of `atoms` slices of
    SLICE_BYTES a weight row, `kc` input channels in all. For a channel it
    stages the input rows its pixels' windows touch: counted over the batch
    as padded rows
    v = b*(H + 2p) + ih + p they are consecutive, at most `rows` of them
    for any tile. A staged row is `rs` elements (its data after `lp` zero
    elements, so that 16-byte copies land aligned; the next row's zeros
    are its right padding), a staged channel `ch` elements, a stage's A
    tile `a_stage` bytes; `vec` says whether rows of x are whole 16-byte
    chunks (else they are staged element by element). `table` is the
    number of entries of the block's copy table, `smem` the dynamic shared
    memory in bytes, `part` the shape of the per-tile partial sums the
    kernel writes (sum y and sum y^2, a row a tile)."""
    oh, ow = out_hw(h, stride, padding), out_hw(w, stride, padding)
    m, vh = b * oh * ow, h + 2 * padding
    tiles = -(-m // TILE_M)
    epc = 16 // itemsize
    if itemsize == 4:
        bn, atoms = F32_TILE_N, 1
    else:
        # wide tiles while they still give every SM a block and a half; a
        # long K (16 slices or more) takes two slices a stage
        bn = 64 if (c_out > 32
                    and 2 * tiles * -(-c_out // 64) >= 3 * SM_COUNT) else 32
        atoms = 2 if c_in * 16 * itemsize >= 16 * SLICE_BYTES else 1
    kc = atoms * SLICE_BYTES // (16 * itemsize)
    n_tiles = -(-c_out // bn)

    def rows_of(tile):
        r0 = tile * TILE_M // ow
        r1 = (min((tile + 1) * TILE_M, m) - 1) // ow
        v0 = r0 // oh * vh + r0 % oh * stride
        return r1 // oh * vh + r1 % oh * stride + KERNEL - v0

    rows = max(rows_of(t) for t in range(tiles))
    vec = w % epc == 0
    lp = epc if padding else 0
    rs = w + lp if vec else -(-(w + lp) // 2) * 2
    ch = -(-(rows * rs) // epc) * epc + epc
    a_stage = -(-(kc * ch * itemsize) // 16) * 16 + 16
    ring = STAGES * (atoms * bn * SLICE_BYTES + a_stage)
    cs = bn * (TILE_M + 4) * 4
    table = rows * (w // epc if vec else 1)
    return dict(tile_m=TILE_M, bn=bn, tiles=tiles, n_tiles=n_tiles,
                stages=STAGES, atoms=atoms, kc=kc, rows=rows, rs=rs, ch=ch,
                lp=lp, vec=int(vec), a_stage=a_stage, table=table,
                smem=1024 + max(ring, cs) + 8 * table,
                part=(2, tiles, c_out))


def conv2d_moments_plain(x, w, stride: int, padding: int):
    """F.conv2d in x's dtype, then the sums in f32 over the rounded y."""
    y = F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)
    yf = y.float()
    return y, yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))


def _check(name, x, w, stride, padding):
    req = _cuda.require
    req(x.ndim == 4 and w.ndim == 4, name,
        f"takes NCHW x and OIHW w, got {tuple(x.shape)}, {tuple(w.shape)}")
    req(supported(tuple(x.shape), w.shape[-1], stride, padding)
        and w.shape[-2] == w.shape[-1], name,
        f"takes 4x4 kernels at stride 2 padding 1 (even H, W) or stride 1 "
        f"padding 0, got x {tuple(x.shape)}, k {w.shape[-1]}, stride "
        f"{stride}, padding {padding}")
    req(w.shape[1] == x.shape[1], name,
        f"w has {w.shape[1]} input channels, x {x.shape[1]}")
    req(x.dtype in _DTYPES and w.dtype == x.dtype, name,
        f"takes float32 or bfloat16 x and w of x's dtype, got {x.dtype}, "
        f"{w.dtype}")
    for t in (x, w):
        req(t.is_cuda and t.device == x.device, name,
            "inputs must lie on one CUDA device")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    geo = launch_geometry(*x.shape, w.shape[0], stride, padding,
                          x.element_size())
    req(geo["smem"] <= MAX_SMEM, name,
        f"a tile of x {tuple(x.shape)} needs {geo['smem']} bytes of shared "
        f"memory, above {MAX_SMEM}")
    return geo


def conv2d_moments_fwd(x, w, stride: int, padding: int):
    """Launch the kernel: x (B, C_in, H, W), w (C_out, C_in, 4, 4), one
    dtype (f32 or bf16), contiguous, on a CUDA device -> (y NCHW in x's
    dtype, s (C_out,) f32, q (C_out,) f32)."""
    name = "conv2d_moments"
    geo = _check(name, x, w, stride, padding)
    b, c_in, h, wd = (int(d) for d in x.shape)
    c_out = int(w.shape[0])
    oh, ow = out_hw(h, stride, padding), out_hw(wd, stride, padding)
    # the kernel copies 16 bytes at a time from 16-byte boundaries
    x, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, w))
    y = torch.empty((b, c_out, oh, ow), dtype=x.dtype, device=x.device)
    part = torch.empty(geo["part"], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _cuda.library().mvae_conv_moments(
            x.data_ptr(), w.data_ptr(), int(x.dtype == torch.bfloat16),
            y.data_ptr(), part.data_ptr(), b, c_in, h, wd, c_out, stride,
            padding, oh, ow, *(geo[k] for k in _GEOMETRY_ARGS),
            _cuda.stream(x.device))
    _cuda.check(name, rc)
    _cuda.launched(conv2d_moments_fwd)
    s, q = part.sum(dim=1)      # the per-tile partials, in a fixed order
    return y, s, q


conv2d_moments_fwd.launches = 0


class _Conv2dMoments(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        fwd = (conv2d_moments_fwd if _cuda.use_kernel(x, w)
               else conv2d_moments_plain)
        y, s, q = fwd(x, w, stride, padding)
        ctx.save_for_backward(x, w, y)
        ctx.conv = (stride, padding)
        return y.float(), s, q

    @staticmethod
    def backward(ctx, gy, gs, gq):
        x, w, y = ctx.saved_tensors
        stride, padding = ctx.conv
        per_channel = (1, -1, 1, 1)
        dy = (gy.float() + gs.view(per_channel)
              + 2.0 * y.float() * gq.view(per_channel)).to(y.dtype)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy, x, w, None, [stride] * 2, [padding] * 2, [1, 1], False,
            [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                        False])
        return dx, dw, None, None


def conv2d_moments(x, w, stride: int, padding: int):
    """Differentiable conv2d + moment sums (see the module docstring).

    x (B, C_in, H, W) and w (C_out, C_in, 4, 4) in one dtype (f32 or bf16).
    Returns (y (B, C_out, OH, OW): its values rounded to x's dtype, held in
    f32; s, q (C_out,) f32). CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if not supported(tuple(x.shape), w.shape[-1], stride, padding):
        raise ValueError(
            f"conv2d_moments: unsupported conv, x {tuple(x.shape)}, k "
            f"{w.shape[-1]}, stride {stride}, padding {padding}")
    return _Conv2dMoments.apply(x.contiguous(), w.contiguous(), stride,
                                padding)
