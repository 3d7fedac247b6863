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
    bn_normalize     _k_normalize      y, from the sums: mean, var, a, b
    bn_bwd_partials  _k_bwd_partials   sum dz, sum dz*x per (g, c)
    bn_dx            _k_dx             dx = P*dz + Q + R*x, from the sums:
                                       P, Q, R and dscale, dbias

with dz = g * swish'(z) recomputed inside each backward pass. The per-(g, c)
algebra between the passes (bn_affine, bn_dx_coeffs; the JAX package's jnp
around its Pallas calls) is part of bn_normalize and bn_dx, kernels and
plain versions alike, so a layer on the card is four launches. mean and var
feed only the running-statistics EMA (core/engine.py:commit_ema_states),
so they are marked non-differentiable: the backward's g_mean and g_var
terms of bn_pallas.py:_vjp_bwd are zero and drop out of P, Q and R.

Data parallelism (`group`, a torch.distributed process group whose ranks
each hold b rows of one batch): the statistics are those of the whole
batch, as one device computes them (SyncBatchNorm on the op's own sums).
The (G, C) sums of bn_moments go through one all-reduce before
bn_normalize, those of bn_bwd_partials through one before bn_dx, and n is
the count over all ranks, b * world * S (every rank holds as many rows).
bn_dx then gives every rank the gradient of the sum of all ranks' losses
for dscale and dbias; each rank keeps its share, that sum over the world,
so that the train step's gradient average (train/loop.py) gives the
gradient of the mean loss, as for every other parameter. dx needs the
global sums as they are. The kernels do not change: the collectives run
between their launches.
"""

import ctypes
import functools

import torch
import torch.distributed as dist

from mvae_tpu_torch.ops import _cuda
from mvae_tpu_torch.ops._cuda import MAX_CLUSTER, SM_COUNT, pow2_at_least
from mvae_tpu_torch.parallel.collectives import all_reduce_sum

EPS = 1e-5
_DTYPES = (torch.float32, torch.bfloat16)
# bn_moments and bn_bwd_partials (one kernel, bn_reduce_kernel):
REDUCE_LOADS = 8            # a plane takes one block (a plain launch) where
                            # its threads load at most this many chunks each
PLANE_THREADS = 512         # ... that block
SPLIT_THREADS = 256         # else its rows are split over a cluster of
REDUCE_TARGET_BLOCKS = 4 * SM_COUNT  # blocks this size, up to 4 an SM
COLUMNS_WIDE = 8            # the columns mapping: channels a block
STREAM_THREADS = 256                # bn_normalize, bn_dx: a block
STREAM_BLOCKS_PER_SM = 4            # ... resident an SM: one wave at most
STREAM_UNROLL = 2                   # ... chunks of x (and g) a thread loads


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


@_cuda.one_op("bn_moments")
def bn_moments_plain(x4):
    """(G, N, C, S) -> (sum x, sum x^2), each (G, C) f32."""
    xf = x4.float()
    return xf.sum(dim=(1, 3)), (xf * xf).sum(dim=(1, 3))


@_cuda.one_op("bn_normalize")
def bn_normalize_plain(x4, s, q, n, scale, bias):
    """The forward from the moments' sums (s, q) over n elements a (g, c):
    (y, mean, var, a, b, invstd); y = swish(x * a + b) in f32, rounded
    once to x's dtype, the rest (G, C) f32."""
    mean, var, invstd, a, b = bn_affine(s, q, n, scale, bias)
    z = _z(x4, a, b)
    y = (z * torch.reciprocal(1.0 + torch.exp(-z))).to(x4.dtype)
    return y, mean, var, a, b, invstd


@_cuda.one_op("bn_bwd_partials")
def bn_bwd_partials_plain(x4, g4, a, b):
    """(sum dz, sum dz * x), each (G, C) f32."""
    dz = _dz(x4, g4, a, b)
    return dz.sum(dim=(1, 3)), (dz * x4.float()).sum(dim=(1, 3))


@_cuda.one_op("bn_dx")
def bn_dx_plain(x4, g4, sdz, sdzx, n, a, b, mean, invstd):
    """The backward from bn_bwd_partials' sums (sdz, sdzx) and the
    forward's (G, C) vectors: (dx, dscale, dbias), dx = P * dz + Q + R * x
    in f32 rounded once to x's dtype; dscale and dbias (C,) f32, summed over
    the groups, which share the scale and bias."""
    sdzxh, q, r = bn_dx_coeffs(sdz, sdzx, n, a, mean, invstd)
    dz = _dz(x4, g4, a, b)
    dx = (_per_channel(a) * dz + _per_channel(q)
          + _per_channel(r) * x4.float()).to(x4.dtype)
    return dx, sdzxh.sum(0), sdz.sum(0)


def _check(name, x4, *vecs, g4=None, channel=()):
    """x4 (and g4) a (G, N, C, S) f32 or bf16 view, vecs (G, C) f32 and
    `channel` (C,) f32, all contiguous on one CUDA device."""
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
    for t in (x4, *vecs, *channel) + (() if g4 is None else (g4,)):
        req(t.is_cuda and t.device == x4.device, name,
            "inputs must lie on one CUDA device")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    for v in vecs:
        req(v.dtype == torch.float32 and v.shape == (gsz, c), name,
            f"per-group inputs are ({gsz}, {c}) float32")
    for v in channel:
        req(v.dtype == torch.float32 and v.shape == (c,), name,
            f"per-channel inputs are ({c},) float32")


def _dims(x4):
    return tuple(int(d) for d in x4.shape)


@functools.lru_cache(maxsize=None)
def reduce_launch(g: int, n: int, c: int, s: int, itemsize: int,
                  aligned: bool, inputs: int) -> dict:
    """How bn_moments (`inputs` = 1: x) and bn_bwd_partials (2: x and g)
    are launched on a (G, N, C, S) view (csrc/bn_swish.cu:
    bn_reduce_kernel): every block sums `rows` consecutive rows of its
    planes; the `splits` blocks that share planes (grid.y) are one thread
    block cluster, at most MAX_CLUSTER, whose first block adds their sums
    in rank order. A launch of one split is a plain launch, which costs
    the card less than a cluster's.

    columns = 0: a block is one plane's rows [y * rows, (y + 1) * rows),
    `tpr` threads along a row's chunks of `vec` elements (16 bytes where S
    holds whole chunks and the tensors are `aligned`, else one element)
    and threads / tpr down the rows; grid (G * C, splits).
    columns = 1 (runs of S shorter than 16 bytes, S = 1 for BatchNorm1d):
    a block is `tpr` = COLUMNS_WIDE consecutive channels of a group by
    threads / tpr row lanes, a thread all S elements of its channel in a
    row; grid (G * ceil(C / COLUMNS_WIDE), splits).
    Either way the block's rows are one block of PLANE_THREADS where its
    threads would load at most REDUCE_LOADS chunks each; else they are
    split over blocks of SPLIT_THREADS, as many as bring the grid to
    REDUCE_TARGET_BLOCKS. Where the planes alone reach that many blocks
    (celeba19's decoder at G = 21), the rows stay one block of
    PLANE_THREADS."""
    columns = int(s * itemsize < 16)
    if columns:
        vec, per_row = 1, s
        across = g * -(-c // COLUMNS_WIDE)
    else:
        v = 16 // itemsize
        vec = v if (s % v == 0 and aligned) else 1
        per_row = s // vec
        across = g * c

    def along(threads):
        """Threads along a row (rows) or channels a block (columns), and
        the chunks a thread loads of each tensor in a row."""
        if columns:
            return COLUMNS_WIDE, per_row
        tpr = pow2_at_least(per_row, threads)
        return tpr, -(-per_row // tpr)

    threads = PLANE_THREADS
    tpr, per_thread = along(threads)
    loads = -(-n // (threads // tpr)) * per_thread * inputs
    splits = 1
    if loads > REDUCE_LOADS:
        threads = SPLIT_THREADS
        tpr, _ = along(threads)
        splits = max(1, min(MAX_CLUSTER, n,
                            -(-REDUCE_TARGET_BLOCKS // across)))
        if splits == 1:
            threads = PLANE_THREADS
            tpr, _ = along(threads)
    rows = -(-n // splits)
    splits = -(-n // rows)
    return dict(columns=columns, vec=vec, splits=splits, rows=rows,
                threads=threads, tpr=tpr, grid=(across, splits))


@functools.lru_cache(maxsize=None)
def _c_reduce(dims, itemsize, aligned, inputs):
    """reduce_launch(...)'s geometry as the C entry points take it: 6 ints
    (csrc/bn_swish.cu: reduce_of)."""
    lay = reduce_launch(*dims, itemsize, aligned, inputs)
    return (ctypes.c_int * 6)(*(lay[k] for k in (
        "columns", "vec", "splits", "rows", "threads", "tpr")))


def _reduce_geometry(*tensors):
    """The C geometry of a reduction over tensors (x, or x and g)."""
    x4 = tensors[0]
    return _c_reduce(_dims(x4), x4.element_size(),
                     all(t.data_ptr() % 16 == 0 for t in tensors),
                     len(tensors))


@_cuda.one_op("bn_moments")
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
            q.data_ptr(), *_dims(x4), _reduce_geometry(x4),
            _cuda.stream(x4.device))
    _cuda.check(name, rc)
    _cuda.launched(bn_moments)
    return s, q


@_cuda.one_op("bn_bwd_partials")
def bn_bwd_partials(x4, g4, a, b):
    """Launch the backward partials kernel -> (sum dz, sum dz * x), each
    (G, C) f32; g4 matches x4."""
    name = "bn_bwd_partials"
    _check(name, x4, a, b, g4=g4)
    gsz, _, c, _ = x4.shape
    sdz = torch.empty((gsz, c), device=x4.device, dtype=torch.float32)
    sdzx = torch.empty_like(sdz)
    with torch.cuda.device(x4.device):
        rc = _cuda.library().mvae_bn_bwd_partials(
            x4.data_ptr(), g4.data_ptr(), int(x4.dtype == torch.bfloat16),
            a.data_ptr(), b.data_ptr(), sdz.data_ptr(), sdzx.data_ptr(),
            *_dims(x4), _reduce_geometry(x4, g4), _cuda.stream(x4.device))
    _cuda.check(name, rc)
    _cuda.launched(bn_bwd_partials)
    return sdz, sdzx


def fast_div(d: int) -> tuple:
    """(m, s) with n // d == (n * m) >> (32 + s) for every 0 <= n < 2^31:
    m = ceil(2^(31 + l) / d), s = l - 1, l = ceil(log2 d); (0, 0) for d = 1,
    which the kernel takes as n itself (csrc/bn_swish.cu: FastDiv)."""
    if d == 1:
        return 0, 0
    lg = (d - 1).bit_length()
    return -(-(1 << (31 + lg)) // d), lg - 1


def _stream_launch(g, n, c, s, itemsize, offsets):
    numel = g * n * c * s
    v = 16 // itemsize
    off = offsets[0]
    vec = v if all(o == off for o in offsets) and off % itemsize == 0 else 1
    head = min(numel, (16 - off) % 16 // itemsize) if vec > 1 else 0
    chunks = (numel - head) // vec
    tail = numel - head - chunks * vec
    per_sm = -(-chunks // (SM_COUNT * STREAM_THREADS))
    per_sm = min(STREAM_BLOCKS_PER_SM, max(1, per_sm))
    whole = s % vec == 0 and head == 0
    return dict(vec=vec, head=head, chunks=chunks, tail=tail,
                whole=int(whole), unroll=STREAM_UNROLL,
                threads=STREAM_THREADS, blocks=SM_COUNT * per_sm,
                divs=fast_div(s) + fast_div(c) + fast_div(n * c * s))


@functools.lru_cache(maxsize=None)
def normalize_launch(g: int, n: int, c: int, s: int, itemsize: int,
                     offsets: tuple = (0, 0)) -> dict:
    """How bn_normalize streams a (G, N, C, S) view (csrc/bn_swish.cu:
    stream). `offsets`: x's and y's addresses modulo 16. The tensor is one
    run of numel elements: `head` elements before x's first 16-byte
    boundary, `chunks` chunks of `vec` elements (16 bytes; 1 where the
    offsets differ), `tail` elements after. Thread t of the grid's
    blocks * threads takes chunks t, t + blocks * threads, ..., `unroll` of
    them loaded at once; threads t < head + tail take the head's and the
    tail's elements. `whole`: every chunk lies in one channel (S a multiple
    of vec, no head). The grid is one wave: SM_COUNT times up to
    STREAM_BLOCKS_PER_SM blocks, fewer where a thread would then have no
    chunk, so a small tensor is spread one chunk a thread. Each chunk
    (each element, where chunks cross channels) forms its coefficients
    (a, b) from the (G, C) sums in the shadow of its loads. `divs`:
    fast_div of S, C and N * C * S, the divisions that give an element's
    (g, c). `unroll` and `threads` are the kernel's own constants
    (kStreamUnroll, kStreamThreads), by which the grid is sized; the C
    entry point takes the rest."""
    return _stream_launch(g, n, c, s, itemsize, offsets)


@functools.lru_cache(maxsize=None)
def dx_launch(g: int, n: int, c: int, s: int, itemsize: int,
              offsets: tuple = (0, 0, 0)) -> dict:
    """How bn_dx streams a (G, N, C, S) view: normalize_launch's geometry
    over x, g and dx (`offsets`: their addresses modulo 16); a chunk forms
    (a, b, Q, R)."""
    return _stream_launch(g, n, c, s, itemsize, offsets)


@functools.lru_cache(maxsize=None)
def _c_launch(launch, dims, itemsize, offsets):
    """launch(...)'s geometry as the C entry points take it: 6 ints and
    6 unsigned (csrc/bn_swish.cu: stream_of)."""
    lay = launch(*dims, itemsize, offsets)
    geo = (ctypes.c_int * 6)(*(lay[k] for k in (
        "vec", "head", "chunks", "tail", "whole", "blocks")))
    return geo, (ctypes.c_uint * 6)(*lay["divs"])


def _offsets(*tensors):
    return tuple(t.data_ptr() % 16 for t in tensors)


def _empty_as(x4):
    """An uninitialized tensor like x4 at x4's offset from a 16-byte
    boundary, so that the stream's chunks are aligned in both."""
    off = x4.data_ptr() % 16 // x4.element_size()
    if off == 0:
        return torch.empty_like(x4)
    flat = torch.empty(x4.numel() + off, dtype=x4.dtype, device=x4.device)
    return flat[off:].view(x4.shape)


@_cuda.one_op("bn_normalize")
def bn_normalize(x4, s, q, n, scale, bias):
    """Launch the normalize kernel: from the moments' sums s, q (G, C) over
    n elements and the affine scale, bias (C,) f32 -> (y in x's dtype,
    mean, var, a, b, invstd, each (G, C) f32), as bn_normalize_plain."""
    name = "bn_normalize"
    _check(name, x4, s, q, channel=(scale, bias))
    gsz, _, c, _ = x4.shape
    y = _empty_as(x4)
    vecs = torch.empty((5, gsz, c), device=x4.device, dtype=torch.float32)
    geo, div = _c_launch(normalize_launch, _dims(x4), x4.element_size(),
                         _offsets(x4, y))
    with torch.cuda.device(x4.device):
        rc = _cuda.library().mvae_bn_normalize(
            x4.data_ptr(), int(x4.dtype == torch.bfloat16), s.data_ptr(),
            q.data_ptr(), scale.data_ptr(), bias.data_ptr(), float(n),
            y.data_ptr(), vecs.data_ptr(), *_dims(x4), geo, div,
            _cuda.stream(x4.device))
    _cuda.check(name, rc)
    _cuda.launched(bn_normalize)
    return (y, *vecs.unbind(0))


@_cuda.one_op("bn_dx")
def bn_dx(x4, g4, sdz, sdzx, n, a, b, mean, invstd):
    """Launch the dx kernel: from bn_bwd_partials' sums sdz, sdzx (G, C)
    over n elements and the forward's a, b, mean, invstd (G, C) f32 ->
    (dx in x's dtype, dscale, dbias (C,) f32), as bn_dx_plain."""
    name = "bn_dx"
    _check(name, x4, sdz, sdzx, a, b, mean, invstd, g4=g4)
    c = x4.shape[2]
    dx = _empty_as(x4)
    dscale = torch.empty((c,), device=x4.device, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    geo, div = _c_launch(dx_launch, _dims(x4), x4.element_size(),
                         _offsets(x4, g4, dx))
    with torch.cuda.device(x4.device):
        rc = _cuda.library().mvae_bn_dx(
            x4.data_ptr(), g4.data_ptr(), int(x4.dtype == torch.bfloat16),
            sdz.data_ptr(), sdzx.data_ptr(), a.data_ptr(), b.data_ptr(),
            mean.data_ptr(), invstd.data_ptr(), float(n), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), *_dims(x4), geo, div,
            _cuda.stream(x4.device))
    _cuda.check(name, rc)
    _cuda.launched(bn_dx)
    return dx, dscale, dbias


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


def _global(sums, n, group):
    """A reduction's (G, C) sums over n elements a (g, c) on this rank ->
    those over the group's ranks, and their count."""
    if group is None:
        return sums, n
    return all_reduce_sum(group, *sums), n * dist.get_world_size(group)


def _fwd(passes, x4, scale, bias, group=None):
    """(y, mean, var, a, b, invstd)."""
    moments, normalize = passes[:2]
    s, q = moments(x4)
    (s, q), n = _global((s, q), x4.shape[1] * x4.shape[3], group)
    return normalize(x4, s, q, n, scale, bias)


def _bwd(passes, x4, g4, a, b, mean, invstd, group=None):
    """(dx, dscale, dbias); the scale and bias are shared by the groups,
    so their gradients sum over them. Under a group of world > 1 ranks,
    dscale and dbias are this rank's share (the module docstring)."""
    partials, dx_fn = passes[2:]
    sums, n = _global(partials(x4, g4, a, b), x4.shape[1] * x4.shape[3],
                      group)
    dx, dscale, dbias = dx_fn(x4, g4, *sums, n, a, b, mean, invstd)
    world = 1 if group is None else dist.get_world_size(group)
    if world > 1:
        dscale, dbias = dscale / world, dbias / world
    return dx, dscale, dbias


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
    forward, and the backward takes the same one. On the kernels a layer
    is four launches: bn_moments, bn_normalize; bn_bwd_partials, bn_dx
    (and under a process group one all-reduce after each reduction).
    The gradients of mean and var, which are not differentiable, are not
    materialized (autograd would fill two (G, C) tensors with zeros)."""

    @staticmethod
    def forward(ctx, x4, scale, bias, group):
        kernel = _cuda.use_kernel(x4, scale, bias)
        y, mean, var, a, b, invstd = _fwd(_PASSES[kernel], x4, scale, bias,
                                          group)
        ctx.kernel, ctx.group = kernel, group
        ctx.save_for_backward(x4, a, b, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x4, a, b, mean, invstd = ctx.saved_tensors
        dx, dscale, dbias = _bwd(_PASSES[ctx.kernel], x4, g.contiguous(), a,
                                 b, mean, invstd, ctx.group)
        return dx, dscale, dbias, None


def bn_swish_train(x, scale, bias, groups: int = 1, group=None):
    """Fused train-mode BatchNorm + swish with statistics per group.

    x: (G*N, C, *spatial) or (G*N, C), f32 or bf16, rows grouped
    term-major; scale, bias: (C,) f32. Returns (y like x, mean (G, C),
    var (G, C)): mean and var are the biased one-pass batch moments in f32
    (non-differentiable). CPU tensors take the plain versions, CUDA
    tensors the kernels. group: a torch.distributed process group whose
    ranks hold the other rows of the batch, each as many as this one
    (the statistics are then the whole batch's), or None.
    """
    rows, c = x.shape[0], x.shape[1]
    if rows % groups:
        raise ValueError(f"{rows} rows do not split into {groups} groups")
    x4 = x.contiguous().view(groups, rows // groups, c, -1)
    y, mean, var = _BNSwishTrain.apply(x4, scale, bias, group)
    return y.view(x.shape), mean, var
