"""Train-mode BatchNorm + swish with per-group statistics: the four CUDA
kernels of csrc/bn_swish.cu, their plain PyTorch versions, and the autograd.

Counterpart of mvae_tpu/ops/bn_pallas.py:bn_swish_train, with the term
axis written out: the JAX package vmaps its decoders over the ELBO terms,
so each term's BatchNorm sees its own batch statistics; here the T terms'
rows run as one batch and the op keeps statistics per group.

    x (G*N, C, *spatial) or (G*N, C)  is viewed as  (G, N, C, S)
    mean, var (G, C):  biased one-pass moments over (N, S), var >= 0
    y = swish(x * a + b)  in f32, rounded once to x's dtype,
        a = scale * rsqrt(var + eps),  b = bias - mean * a

The four passes (the kernel's name, then the TPU kernel it replaces):

    bn_moments       _k_moments        sum x, sum x^2 per (g, c)
    bn_normalize     _k_normalize      y
    bn_bwd_partials  _k_bwd_partials   sum dz, sum dz*x per (g, c)
    bn_dx            _k_dx             dx = P*dz + Q + R*x

with dz = g * swish'(z) recomputed inside each backward pass. mean and var
feed only the running-statistics EMA (core/engine.py:commit_ema_states),
so they are marked non-differentiable: the backward's g_mean and g_var
terms of bn_pallas.py:_vjp_bwd are zero and drop out of P, Q and R.
"""

import functools

import torch

from mvae_tpu_torch.ops import _cuda

EPS = 1e-5
_DTYPES = (torch.float32, torch.bfloat16)
PARTIALS_TARGET_BLOCKS = 4 * 132    # bn_bwd_partials: 4 blocks an SM (H100)
PARTIALS_THREADS = 256              # a block, at most
PARTIALS_UNROLL = 2                 # rows a thread has in flight
MAX_CLUSTER = 8                     # blocks that share a plane: one cluster
COLUMNS_WIDE, COLUMNS_DEEP = 32, 8  # the columns mapping: channels x row lanes


def _per_channel(v):
    """(G, C) -> (G, 1, C, 1), to broadcast over a (G, N, C, S) view."""
    return v[:, None, :, None]


def _z(x4, a, b):
    return x4.float() * _per_channel(a) + _per_channel(b)


def _dz(x4, g4, a, b):
    """g * swish'(z), f32, with the kernel's sigmoid 1 / (1 + exp(-z))."""
    z = _z(x4, a, b)
    s = torch.reciprocal(1.0 + torch.exp(-z))
    return g4.float() * (s * (1.0 + z * (1.0 - s)))


def bn_moments_plain(x4):
    """(G, N, C, S) -> (sum x, sum x^2), each (G, C) f32."""
    xf = x4.float()
    return xf.sum(dim=(1, 3)), (xf * xf).sum(dim=(1, 3))


def bn_normalize_plain(x4, a, b):
    """swish(x * a + b) in f32, rounded once to x's dtype."""
    z = _z(x4, a, b)
    return (z * torch.reciprocal(1.0 + torch.exp(-z))).to(x4.dtype)


def bn_bwd_partials_plain(x4, g4, a, b):
    """(sum dz, sum dz * x), each (G, C) f32."""
    dz = _dz(x4, g4, a, b)
    return dz.sum(dim=(1, 3)), (dz * x4.float()).sum(dim=(1, 3))


def bn_dx_plain(x4, g4, a, b, p, q, r):
    """P * dz + Q + R * x in f32, rounded once to x's dtype."""
    dz = _dz(x4, g4, a, b)
    return (_per_channel(p) * dz + _per_channel(q)
            + _per_channel(r) * x4.float()).to(x4.dtype)


def _check(name, x4, *vecs, g4=None):
    req = _cuda.require
    req(x4.ndim == 4, name,
        f"takes a (G, N, C, S) view, got {tuple(x4.shape)}")
    gsz, _, c, _ = x4.shape
    req(x4.numel() >= 1, name, "empty input")
    req(x4.dtype in _DTYPES, name,
        f"takes float32 or bfloat16, got {x4.dtype}")
    if g4 is not None:
        req(g4.shape == x4.shape and g4.dtype == x4.dtype, name,
            "the gradient must match x in shape and dtype")
    for t in (x4, *vecs) + (() if g4 is None else (g4,)):
        req(t.is_cuda and t.device == x4.device, name,
            "inputs must lie on one CUDA device")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    for v in vecs:
        req(v.dtype == torch.float32 and v.shape == (gsz, c), name,
            f"per-channel inputs are ({gsz}, {c}) float32")


def _dims(x4):
    return tuple(int(d) for d in x4.shape)


def bn_moments(x4):
    """Launch the moments kernel: x4 (G, N, C, S) f32 or bf16, contiguous,
    on a CUDA device -> (sum x, sum x^2), each (G, C) f32."""
    name = "bn_moments"
    _check(name, x4)
    gsz, _, c, _ = x4.shape
    s = torch.empty((gsz, c), device=x4.device, dtype=torch.float32)
    q = torch.empty_like(s)
    with torch.cuda.device(x4.device):
        rc = _cuda.library().mvae_bn_moments(
            x4.data_ptr(), int(x4.dtype == torch.bfloat16), s.data_ptr(),
            q.data_ptr(), *_dims(x4), _cuda.stream(x4.device))
    _cuda.check(name, rc)
    bn_moments.launches += 1
    return s, q


def bn_normalize(x4, a, b):
    """Launch the normalize kernel: y = swish(x * a + b) in x's dtype; a, b
    (G, C) f32."""
    name = "bn_normalize"
    _check(name, x4, a, b)
    y = torch.empty_like(x4)
    with torch.cuda.device(x4.device):
        rc = _cuda.library().mvae_bn_normalize(
            x4.data_ptr(), int(x4.dtype == torch.bfloat16), a.data_ptr(),
            b.data_ptr(), y.data_ptr(), *_dims(x4), _cuda.stream(x4.device))
    _cuda.check(name, rc)
    bn_normalize.launches += 1
    return y


def _pow2_at_least(v: int, cap: int) -> int:
    t = 1
    while t < cap and t < v:
        t *= 2
    return t


@functools.lru_cache(maxsize=None)
def bwd_partials_launch(g: int, n: int, c: int, s: int, itemsize: int,
                        aligned: bool = True) -> dict:
    """How bn_bwd_partials is launched on a (G, N, C, S) view: every block
    sums `rows` consecutive rows of its planes; the `splits` blocks that
    share planes (grid.y) are one thread block cluster, at most
    MAX_CLUSTER, whose first block adds their sums in rank order.

    columns = 1 (runs of S shorter than 16 bytes, S = 1 for BatchNorm1d):
    a block is COLUMNS_WIDE consecutive channels of a group by COLUMNS_DEEP
    row lanes, each lane with PARTIALS_UNROLL rows in flight; grid
    (G * ceil(C / COLUMNS_WIDE), splits).
    columns = 0: a block is one plane's rows [y * rows, (y + 1) * rows),
    `tpr` threads along a row's chunks of `vec` elements (16 bytes where S
    holds whole chunks and the tensors are `aligned`, else one element)
    and threads / tpr down the rows; grid (G * C, splits). The block is
    the largest that still leaves PARTIALS_TARGET_BLOCKS blocks (else the
    one with the most blocks), and its rows are what its threads hold in
    flight at once where the cluster allows."""
    least = -(-n // MAX_CLUSTER)
    if s * itemsize < 16:
        rows = max(least, min(n, COLUMNS_DEEP * PARTIALS_UNROLL))
        splits = -(-n // rows)
        return dict(columns=1, vec=1, splits=splits, rows=rows,
                    threads=COLUMNS_WIDE * COLUMNS_DEEP, tpr=COLUMNS_WIDE,
                    grid=(g * -(-c // COLUMNS_WIDE), splits))
    v = 16 // itemsize
    vec = v if (s % v == 0 and aligned) else 1
    per_row = s // vec
    planes = g * c
    best = None
    for threads in (PARTIALS_THREADS, 128, 64, 32):
        tpr = _pow2_at_least(per_row, threads)
        rows = max(least, min(n, threads // tpr * PARTIALS_UNROLL))
        splits = -(-n // rows)
        key = (min(planes * splits, PARTIALS_TARGET_BLOCKS), threads)
        if best is None or key > best[0]:
            best = (key, dict(columns=0, vec=vec, splits=splits, rows=rows,
                              threads=threads, tpr=tpr,
                              grid=(planes, splits)))
    return best[1]


def bn_bwd_partials(x4, g4, a, b):
    """Launch the backward partials kernel -> (sum dz, sum dz * x), each
    (G, C) f32; g4 matches x4."""
    name = "bn_bwd_partials"
    _check(name, x4, a, b, g4=g4)
    gsz, _, c, _ = x4.shape
    lay = bwd_partials_launch(
        *_dims(x4), x4.element_size(),
        x4.data_ptr() % 16 == 0 and g4.data_ptr() % 16 == 0)
    sdz = torch.empty((gsz, c), device=x4.device, dtype=torch.float32)
    sdzx = torch.empty_like(sdz)
    with torch.cuda.device(x4.device):
        rc = _cuda.library().mvae_bn_bwd_partials(
            x4.data_ptr(), g4.data_ptr(), int(x4.dtype == torch.bfloat16),
            a.data_ptr(), b.data_ptr(), sdz.data_ptr(), sdzx.data_ptr(),
            *_dims(x4), lay["columns"], lay["vec"], lay["splits"],
            lay["rows"], lay["threads"], lay["tpr"],
            _cuda.stream(x4.device))
    _cuda.check(name, rc)
    bn_bwd_partials.launches += 1
    return sdz, sdzx


def bn_dx(x4, g4, a, b, p, q, r):
    """Launch the dx kernel: P * dz + Q + R * x in x's dtype; a, b, p, q, r
    (G, C) f32."""
    name = "bn_dx"
    _check(name, x4, a, b, p, q, r, g4=g4)
    dx = torch.empty_like(x4)
    with torch.cuda.device(x4.device):
        rc = _cuda.library().mvae_bn_dx(
            x4.data_ptr(), g4.data_ptr(), int(x4.dtype == torch.bfloat16),
            a.data_ptr(), b.data_ptr(), p.data_ptr(), q.data_ptr(),
            r.data_ptr(), dx.data_ptr(), *_dims(x4), _cuda.stream(x4.device))
    _cuda.check(name, rc)
    bn_dx.launches += 1
    return dx


for _k in (bn_moments, bn_normalize, bn_bwd_partials, bn_dx):
    _k.launches = 0

_PASSES = {True: (bn_moments, bn_normalize, bn_bwd_partials, bn_dx),
           False: (bn_moments_plain, bn_normalize_plain,
                   bn_bwd_partials_plain, bn_dx_plain)}


def bn_affine(s, q, n, scale, bias):
    """Per-(g, c) algebra between the forward passes (bn_pallas.py:225-231):
    the sums of bn_moments over n elements -> (mean, var, invstd, a, b),
    each (G, C) f32, var clamped at 0."""
    mean = s / n
    var = torch.clamp(q / n - mean * mean, min=0.0)
    invstd = torch.rsqrt(var + EPS)
    a = (scale * invstd).contiguous()
    return mean, var, invstd, a, (bias - mean * a).contiguous()


def bn_dx_coeffs(sdz, sdzx, n, a, mean, invstd):
    """Per-(g, c) algebra between the backward passes (bn_pallas.py:257-268
    with g_mean = g_var = 0): the sums of bn_bwd_partials -> (sum dz*xhat,
    Q, R) of dx = P*dz + Q + R*x, P = a."""
    sdzxh = (sdzx - mean * sdz) * invstd
    r = (-(a * sdzxh) / n) * invstd
    q = -(a * sdz) / n - r * mean
    return sdzxh, q.contiguous(), r.contiguous()


def _fwd(passes, x4, scale, bias):
    moments, normalize = passes[:2]
    n = x4.shape[1] * x4.shape[3]
    mean, var, invstd, a, b = bn_affine(*moments(x4), n, scale, bias)
    return normalize(x4, a, b), mean, var, a, b, invstd


def _bwd(passes, x4, g4, a, b, mean, invstd):
    """(dx, dscale, dbias); the scale and bias are shared by the groups,
    so their gradients sum over them."""
    partials, dx_fn = passes[2:]
    n = x4.shape[1] * x4.shape[3]
    sdz, sdzx = partials(x4, g4, a, b)
    sdzxh, q, r = bn_dx_coeffs(sdz, sdzx, n, a, mean, invstd)
    return dx_fn(x4, g4, a, b, a, q, r), sdzxh.sum(0), sdz.sum(0)


def bn_swish_fwd_plain(x4, scale, bias):
    """The forward in plain PyTorch: (y, mean, var)."""
    y, mean, var, *_ = _fwd(_PASSES[False], x4, scale, bias)
    return y, mean, var


def bn_swish_bwd_plain(x4, g4, scale, bias):
    """The backward in plain PyTorch, the forward's statistics recomputed:
    (dx, dscale, dbias) for the upstream gradient g4 of y."""
    _, mean, _, a, b, invstd = _fwd(_PASSES[False], x4, scale, bias)
    return _bwd(_PASSES[False], x4, g4, a, b, mean, invstd)


class _BNSwishTrain(torch.autograd.Function):
    """The route (kernels or plain versions) is chosen once, in the
    forward, and the backward takes the same one."""

    @staticmethod
    def forward(ctx, x4, scale, bias):
        kernel = _cuda.use_kernel(x4, scale, bias)
        y, mean, var, a, b, invstd = _fwd(_PASSES[kernel], x4, scale, bias)
        ctx.kernel = kernel
        ctx.save_for_backward(x4, a, b, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x4, a, b, mean, invstd = ctx.saved_tensors
        dx, dscale, dbias = _bwd(_PASSES[ctx.kernel], x4, g.contiguous(), a,
                                 b, mean, invstd)
        return dx, dscale, dbias


def bn_swish_train(x, scale, bias, groups: int = 1):
    """Fused train-mode BatchNorm + swish with statistics per group.

    x: (G*N, C, *spatial) or (G*N, C), f32 or bf16, rows grouped
    term-major; scale, bias: (C,) f32. Returns (y like x, mean (G, C),
    var (G, C)): mean and var are the biased one-pass batch moments in f32
    (non-differentiable). CPU tensors take the plain versions, CUDA
    tensors the kernels.
    """
    rows, c = x.shape[0], x.shape[1]
    if rows % groups:
        raise ValueError(f"{rows} rows do not split into {groups} groups")
    x4 = x.contiguous().view(groups, rows // groups, c, -1)
    y, mean, var = _BNSwishTrain.apply(x4, scale, bias)
    return y.view(x.shape), mean, var
