"""Row-summed stable BCE with logits: the CUDA kernel `bce_rowsum_fwd`
(csrc/bce_rowsum.cu), its plain PyTorch version, and the dispatch.

Counterpart of mvae_tpu/ops/elbo_pallas.py, with one extension: the target
rows may be fewer than the logit rows (N = G * Nt) and are then shared by
each group of Nt logit rows, so the eval step's T*B decoded rows read the
B target rows without a repeated copy. The backward is the JAX package's
closed form (elbo_pallas.py:_bwd) in plain PyTorch, used on both devices.
"""

import torch

from mvae_tpu_torch.ops import _cuda

_DTYPES = (torch.float32, torch.bfloat16)


def bce_rowsum_plain(logits, targets):
    """Plain version, mirroring elbo_pallas.py:bce_sum_ref.

    logits: (N, K); targets: (Nt, K) with N % Nt == 0 -> (N,) f32.
    """
    x = logits.float()
    t = targets.float()
    n, k = x.shape
    x = x.reshape(n // t.shape[0], t.shape[0], k)
    bce = torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return bce.sum(-1).reshape(n)


def bce_rowsum_fwd(logits, targets):
    """Launch the kernel. logits: (N, K), targets: (Nt, K), each float32
    or bfloat16, contiguous, on one CUDA device, N % Nt == 0."""
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
    lib = _cuda.library()
    with torch.cuda.device(logits.device):
        rc = lib.mvae_bce_rowsum_fwd(
            logits.data_ptr(), int(logits.dtype == torch.bfloat16),
            targets.data_ptr(), int(targets.dtype == torch.bfloat16),
            out.data_ptr(), n, k, nt, _cuda.stream(logits.device))
    _cuda.check(name, rc)
    bce_rowsum_fwd.launches += 1
    return out


bce_rowsum_fwd.launches = 0


def bce_rowsum_bwd_plain(g, logits, targets, need_targets=False):
    """Closed-form gradients of the row sums for the upstream gradient g
    (N,): g * (sigmoid(x) - t) for the logits, in f32 and returned in the
    logits' dtype, and, if asked, -g * x for the targets, summed over the
    N // Nt groups of rows that share a target row, in the targets' dtype
    (else None). Mirrors elbo_pallas.py:_bwd."""
    n, k = logits.shape
    nt = targets.shape[0]
    x = logits.float().reshape(n // nt, nt, k)
    g3 = g.float().reshape(n // nt, nt, 1)
    gx = (g3 * (torch.sigmoid(x) - targets.float())).reshape(n, k)
    gt = None
    if need_targets:
        gt = (-(g3 * x)).sum(0).to(targets.dtype)
    return gx.to(logits.dtype), gt


class _BceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets):
        ctx.save_for_backward(logits, targets)
        if _cuda.use_kernel(logits, targets):
            return bce_rowsum_fwd(logits, targets)
        return bce_rowsum_plain(logits, targets)

    @staticmethod
    def backward(ctx, g):
        logits, targets = ctx.saved_tensors
        return bce_rowsum_bwd_plain(g, logits, targets,
                                    ctx.needs_input_grad[1])


def bce_sum(logits, targets):
    """logits: (N, K), targets: (Nt, K), N % Nt == 0 -> (N,) row-summed
    stable BCE in f32, differentiable in both. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    return _BceSum.apply(logits, targets)
