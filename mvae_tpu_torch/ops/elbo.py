"""Row-summed stable BCE with logits: the CUDA kernel `bce_rowsum_fwd`
(csrc/bce_rowsum.cu), its plain PyTorch version, and the dispatch.

Counterpart of mvae_tpu/ops/elbo_pallas.py, with one extension: the target
rows may be fewer than the logit rows (N = G * Nt) and are then shared by
each group of Nt logit rows, so the eval step's T*B decoded rows read the
B target rows without a repeated copy. The backward is the JAX package's
closed form (elbo_pallas.py:_bwd) in plain PyTorch, used on both devices.

`bf16_math=True` with bf16 logits: the elementwise math in bf16 steps,
the row sums in f32 (the JAX package's MVAE_BF16_LOSS branch,
core/losses.py:bce_row_sum, as an argument here). XLA may skip the
intermediate roundings of that branch (its excess-precision rewrite), so
the port fixes its own rounding points, in the kernel and the plain
version alike: with t rounded to bf16,

    a = bf16(x * t)              b = bf16(max(x, 0) - a)
    e = bf16(exp(-|x|))          l = bf16(log1p(e))
    element = bf16(b + l), summed over the row in f32,

each operation computed in f32 from its bf16 operands and rounded once,
as PyTorch's bf16 elementwise ops compute it. f32 logits take the f32
math whatever bf16_math says, as the JAX branch does.
"""

import ctypes
import functools

import torch

from mvae_tpu_torch.ops import _cuda
from mvae_tpu_torch.ops._cuda import MAX_CLUSTER, pow2_at_least

_DTYPES = (torch.float32, torch.bfloat16)
BCE_THREADS = 256                  # a block, at most
BCE_CHUNKS = 12                    # wide rows: a row is split over a
                                   # cluster where its threads would take
                                   # more chunks each
BCE_UNROLL = 2                     # chunks of x and of t a thread has in
                                   # flight: the kernel's kUnroll
NARROW = 32                        # rows of at most this many chunks take
                                   # a warp's lanes or fewer each


def bf16_steps(logits, bf16_math: bool) -> bool:
    """Whether the BCE takes the bf16 steps: asked for, with bf16 logits."""
    return bool(bf16_math) and logits.dtype == torch.bfloat16


@_cuda.one_op("bce_rowsum_fwd")
def bce_rowsum_plain(logits, targets, bf16_math=False):
    """Plain version, mirroring elbo_pallas.py:bce_sum_ref; with bf16_math
    and bf16 logits, in the bf16 steps of the module docstring (PyTorch's
    bf16 ops, each rounded once, in that order).

    logits: (N, K); targets: (Nt, K) with N % Nt == 0 -> (N,) f32.
    """
    dt = torch.bfloat16 if bf16_steps(logits, bf16_math) else torch.float32
    x = logits.to(dt)
    t = targets.to(dt)
    n, k = x.shape
    x = x.reshape(n // t.shape[0], t.shape[0], k)
    bce = torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return bce.float().sum(-1).reshape(n)


@functools.lru_cache(maxsize=None)
def bce_launch(n: int, k: int, x_itemsize: int, t_itemsize: int,
               aligned: bool) -> dict:
    """How bce_rowsum_fwd (csrc/bce_rowsum.cu) is launched on n rows of k
    logits: a row is chunks of `vec` elements, 16 bytes of the narrower
    type where k holds whole chunks and both tensors are `aligned`, else
    one element; each thread has `unroll` (BCE_UNROLL, the kernel's
    constant) chunks of x and of t in flight.

    Narrow rows (at most NARROW chunks): `lanes` threads a row (the power
    of 2 at or above its chunks), threads / lanes rows a block, one block
    along the row (splits = 1); grid (ceil(n / (threads / lanes)), 1).
    Wide rows: one row a block (lanes = threads), its chunks cut into
    `splits` spans of `span` chunks, one block each, that are one thread
    block cluster, at most MAX_CLUSTER; grid (n, splits). A block has
    BCE_THREADS threads (fewer where the row's chunks would leave some
    without `unroll` of them), and a row as many blocks as keep each
    thread at BCE_CHUNKS chunks or fewer: one, a plain launch, for the
    CelebA image rows in f32 and bf16."""
    v = 16 // min(x_itemsize, t_itemsize)
    vec = v if k % v == 0 and aligned else 1
    chunks = k // vec
    if chunks <= NARROW:
        lanes = pow2_at_least(chunks, NARROW)
        threads = max(32, pow2_at_least(n * lanes, BCE_THREADS))
        per_block = threads // lanes
        return dict(vec=vec, lanes=lanes, threads=threads, splits=1,
                    span=chunks, unroll=BCE_UNROLL,
                    grid=(-(-n // per_block), 1))
    threads = max(32, pow2_at_least(-(-chunks // BCE_UNROLL), BCE_THREADS))
    splits = min(MAX_CLUSTER, -(-chunks // (threads * BCE_CHUNKS)))
    span = -(-chunks // splits)
    splits = -(-chunks // span)
    return dict(vec=vec, lanes=threads, threads=threads, splits=splits,
                span=span, unroll=BCE_UNROLL, grid=(n, splits))


@functools.lru_cache(maxsize=None)
def _c_launch(n, k, x_itemsize, t_itemsize, aligned):
    """bce_launch(...)'s geometry as the C entry point takes it: 5 ints."""
    lay = bce_launch(n, k, x_itemsize, t_itemsize, aligned)
    return (ctypes.c_int * 5)(*(lay[key] for key in (
        "vec", "lanes", "threads", "splits", "span")))


@_cuda.one_op("bce_rowsum_fwd")
def bce_rowsum_fwd(logits, targets, bf16_math=False):
    """Launch the kernel. logits: (N, K), targets: (Nt, K), each float32
    or bfloat16, contiguous, on one CUDA device, N % Nt == 0; bf16_math:
    the bf16 steps for bf16 logits (module docstring)."""
    name = "bce_rowsum_fwd"
    req = _cuda.require
    req(logits.ndim == 2 and targets.ndim == 2
        and logits.shape[1] == targets.shape[1], name,
        f"takes (N, K) logits and (Nt, K) targets, got "
        f"{tuple(logits.shape)} and {tuple(targets.shape)}")
    n, k = logits.shape
    nt = targets.shape[0]
    req(n >= 1 and k >= 1 and nt >= 1 and n % nt == 0, name,
        f"N={n} must be a positive multiple of Nt={nt}")
    req(n < 2 ** 31 and k < 2 ** 31, name, "too many rows or columns")
    for t in (logits, targets):
        req(t.is_cuda and t.device == logits.device, name,
            "inputs must lie on one CUDA device")
        req(t.dtype in _DTYPES, name,
            f"takes float32 or bfloat16, got {t.dtype}")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    out = torch.empty((n,), device=logits.device, dtype=torch.float32)
    geo = _c_launch(n, k, logits.element_size(), targets.element_size(),
                    logits.data_ptr() % 16 == 0
                    and targets.data_ptr() % 16 == 0)
    lib = _cuda.library()
    with torch.cuda.device(logits.device):
        rc = lib.mvae_bce_rowsum_fwd(
            logits.data_ptr(), int(logits.dtype == torch.bfloat16),
            targets.data_ptr(), int(targets.dtype == torch.bfloat16),
            int(bf16_steps(logits, bf16_math)), out.data_ptr(), n, k, nt,
            geo, _cuda.stream(logits.device))
    _cuda.check(name, rc)
    _cuda.launched(bce_rowsum_fwd)
    return out


bce_rowsum_fwd.launches = 0


def bce_rowsum_bwd_plain(g, logits, targets, need_targets=False,
                         bf16_math=False):
    """Closed-form gradients of the row sums for the upstream gradient g
    (N,): g * (sigmoid(x) - t) for the logits, in f32 and returned in the
    logits' dtype, and, if asked, -g * x for the targets, summed over the
    N // Nt groups of rows that share a target row, in the targets' dtype
    (else None). Mirrors elbo_pallas.py:_bwd.

    With bf16_math and bf16 logits, the logits' gradient takes the bf16
    steps, in the order, that JAX's autodiff of the bf16 branch takes
    (each a PyTorch bf16 op, rounded once): gb = bf16(g), e =
    bf16(exp(-|x|)), soft = bf16(bf16(gb / bf16(1 + e)) e),
        gx = bf16(bf16(-s soft - bf16(gb t)) + gb r),
    s = 1 for x >= 0 and -1 below (the derivative of |x|), r the
    derivative of max(x, 0): 1 above 0, 1/2 at 0, 0 below."""
    n, k = logits.shape
    nt = targets.shape[0]
    if bf16_steps(logits, bf16_math):
        bf = torch.bfloat16
        x = logits.reshape(n // nt, nt, k)
        gb = g.to(bf).reshape(n // nt, nt, 1)
        e = torch.exp(-x.abs())
        soft = gb / (1 + e) * e
        relu = (x > 0).to(bf) + 0.5 * (x == 0).to(bf)
        gx = ((torch.where(x >= 0, -soft, soft) - gb * targets.to(bf))
              + gb * relu).reshape(n, k)
    else:
        x = logits.float().reshape(n // nt, nt, k)
        g3 = g.float().reshape(n // nt, nt, 1)
        gx = (g3 * (torch.sigmoid(x) - targets.float())).reshape(n, k)
    gt = None
    if need_targets:
        x = logits.float().reshape(n // nt, nt, k)
        gt = (-(g.float().reshape(n // nt, nt, 1) * x)).sum(0).to(
            targets.dtype)
    return gx.to(logits.dtype), gt


class _BceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, bf16_math):
        ctx.save_for_backward(logits, targets)
        ctx.bf16_math = bf16_math
        if _cuda.use_kernel(logits, targets):
            return bce_rowsum_fwd(logits, targets, bf16_math)
        return bce_rowsum_plain(logits, targets, bf16_math)

    @staticmethod
    def backward(ctx, g):
        logits, targets = ctx.saved_tensors
        gx, gt = bce_rowsum_bwd_plain(g, logits, targets,
                                      ctx.needs_input_grad[1], ctx.bf16_math)
        return gx, gt, None


def bce_sum(logits, targets, bf16_math=False):
    """logits: (N, K), targets: (Nt, K), N % Nt == 0 -> (N,) row-summed
    stable BCE in f32, differentiable in both; bf16_math: the bf16 steps
    for bf16 logits (module docstring). CPU tensors take the plain
    version, CUDA tensors the kernel."""
    return _BceSum.apply(logits, targets, bf16_math)
