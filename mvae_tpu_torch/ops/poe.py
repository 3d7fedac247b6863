"""Masked product of experts for all ELBO terms at once: the CUDA kernels
`poe_fwd` and `poe_bwd` (csrc/poe.cu), their plain PyTorch versions, and
the dispatch.

Counterpart of mvae_tpu/ops/poe_pallas.py. Semantics equal the JAX
package's core/poe.py:masked_product_of_experts applied to each mask row
(single-eps convention, the N(0, I) prior folded in). The backward is the
JAX package's closed form (poe_pallas.py:_bwd): the kernel `poe_bwd` on
the card, `poe_bwd_plain` on the CPU.
"""

import functools

import torch

from mvae_tpu_torch.ops import _cuda

EPS = 1e-8
EXPERT_CAPS = (2, 8, 32)  # csrc/poe.cu's instantiations: experts a column
                          # holds in registers
MAX_EXPERTS = EXPERT_CAPS[-1]


@_cuda.one_op("poe_fwd")
def poe_plain(mu, logvar, masks):
    """Plain version of the kernel, mirroring poe_pallas.py:_kernel.

    mu, logvar: (M, B, D); masks: (T, M) -> (pd_mu, pd_logvar) (T, B, D), f32.
    """
    m, b, d = mu.shape
    mu2 = mu.float().reshape(m, b * d)
    lv2 = logvar.float().reshape(m, b * d)
    masks = masks.float()
    prec = 1.0 / (torch.exp(lv2) + EPS)
    prior = 1.0 / (1.0 + EPS)
    den = masks @ prec + prior
    num = masks @ (mu2 * prec)
    t = masks.shape[0]
    return (num / den).reshape(t, b, d), (-torch.log(den)).reshape(t, b, d)


@functools.lru_cache(maxsize=None)
def expert_cap(n_experts: int) -> int:
    """The expert cap that poe_fwd and poe_bwd (csrc/poe.cu) are launched
    at for n_experts experts: the least instantiation that holds them."""
    return next(c for c in EXPERT_CAPS if n_experts <= c)


def _check(name, mu, logvar, masks, grads=()):
    """The wrappers' checks: (M, B, D) mu and logvar, (T, M) masks, (T, B,
    D) upstream gradients, all float32, contiguous, on one CUDA device."""
    req = _cuda.require
    req(mu.ndim == 3 and logvar.shape == mu.shape, name,
        f"mu/logvar must share an (M, B, D) shape, got {tuple(mu.shape)} "
        f"and {tuple(logvar.shape)}")
    m, b, d = mu.shape
    req(masks.ndim == 2 and masks.shape[1] == m, name,
        f"masks must be (T, {m}), got {tuple(masks.shape)}")
    req(1 <= m <= MAX_EXPERTS, name, f"takes 1..{MAX_EXPERTS} experts")
    n_terms = masks.shape[0]
    for g in grads:
        req(g.shape == (n_terms, b, d), name,
            f"gradients must be ({n_terms}, {b}, {d}), got {tuple(g.shape)}")
    for t in (mu, logvar, masks, *grads):
        req(t.is_cuda and t.device == mu.device, name,
            "inputs must lie on one CUDA device")
        req(t.dtype == torch.float32, name, f"takes float32, got {t.dtype}")
        req(t.is_contiguous(), name, "inputs must be contiguous")
    req(n_terms >= 1 and b * d >= 1, name, "empty input")


@_cuda.one_op("poe_fwd")
def poe_fwd(mu, logvar, masks):
    """Launch the forward kernel. mu, logvar: (M, B, D) f32 contiguous CUDA
    tensors; masks: (T, M) f32 contiguous on the same device."""
    _check("poe_fwd", mu, logvar, masks)
    m, b, d = mu.shape
    n_terms = masks.shape[0]
    pd_mu = torch.empty((n_terms, b, d), device=mu.device,
                        dtype=torch.float32)
    pd_lv = torch.empty_like(pd_mu)
    lib = _cuda.library()
    with torch.cuda.device(mu.device):
        rc = lib.mvae_poe_fwd(mu.data_ptr(), logvar.data_ptr(),
                              masks.data_ptr(), pd_mu.data_ptr(),
                              pd_lv.data_ptr(), m, n_terms, b * d,
                              expert_cap(m),
                              _cuda.stream(mu.device))
    _cuda.check("poe_fwd", rc)
    _cuda.launched(poe_fwd)
    return pd_mu, pd_lv


poe_fwd.launches = 0


@_cuda.one_op("poe_bwd")
def poe_bwd_plain(mu, logvar, masks, g_mu, g_lv):
    """Closed-form gradients (d_mu, d_logvar), each (M, B, D) f32, of the
    fused posteriors' upstream gradients g_mu, g_lv (T, B, D); mirrors
    poe_pallas.py:_bwd. The masks take no gradient."""
    m, b, d = mu.shape
    t = masks.shape[0]
    mu2 = mu.float().reshape(m, b * d)
    lv2 = logvar.float().reshape(m, b * d)
    masks = masks.float()
    g_mu = g_mu.float().reshape(t, b * d)
    g_lv = g_lv.float().reshape(t, b * d)
    prec = 1.0 / (torch.exp(lv2) + EPS)
    den = masks @ prec + 1.0 / (1.0 + EPS)
    num = masks @ (mu2 * prec)
    d_num = g_mu / den
    d_den = -(g_mu * num) / (den * den) - g_lv / den
    back = masks.t() @ d_num
    d_mu = back * prec
    d_prec = back * mu2 + masks.t() @ d_den
    d_lv = d_prec * (-(prec * prec) * torch.exp(lv2))
    return d_mu.reshape(m, b, d), d_lv.reshape(m, b, d)


@_cuda.one_op("poe_bwd")
def poe_bwd(mu, logvar, masks, g_mu, g_lv):
    """Launch the backward kernel: poe_bwd_plain's (d_mu, d_logvar), each
    (M, B, D) f32. mu, logvar, masks as poe_fwd takes them; g_mu, g_lv:
    (T, B, D) f32 contiguous on the same device."""
    _check("poe_bwd", mu, logvar, masks, (g_mu, g_lv))
    m, b, d = mu.shape
    d_mu = torch.empty_like(mu)
    d_lv = torch.empty_like(mu)
    lib = _cuda.library()
    with torch.cuda.device(mu.device):
        rc = lib.mvae_poe_bwd(mu.data_ptr(), logvar.data_ptr(),
                              masks.data_ptr(), g_mu.data_ptr(),
                              g_lv.data_ptr(), d_mu.data_ptr(),
                              d_lv.data_ptr(), m, masks.shape[0], b * d,
                              expert_cap(m),
                              _cuda.stream(mu.device))
    _cuda.check("poe_bwd", rc)
    _cuda.launched(poe_bwd)
    return d_mu, d_lv


poe_bwd.launches = 0


class _MaskedPoE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, logvar, masks):
        ctx.save_for_backward(mu, logvar, masks)
        if _cuda.use_kernel(mu, logvar, masks):
            return poe_fwd(mu, logvar, masks)
        return poe_plain(mu, logvar, masks)

    @staticmethod
    def backward(ctx, g_mu, g_lv):
        mu, logvar, masks = ctx.saved_tensors
        if _cuda.use_kernel(mu, logvar, masks, g_mu, g_lv):
            d_mu, d_lv = poe_bwd(mu, logvar, masks, g_mu.contiguous(),
                                 g_lv.contiguous())
        else:
            d_mu, d_lv = poe_bwd_plain(mu, logvar, masks, g_mu, g_lv)
        return d_mu.to(mu.dtype), d_lv.to(logvar.dtype), None


def masked_poe_all_terms(mu, logvar, masks):
    """mu, logvar: (M, B, D); masks: (T, M) -> (pd_mu, pd_logvar) (T, B, D),
    differentiable in mu and logvar.

    CPU tensors take the plain versions, CUDA tensors the kernels.
    """
    return _MaskedPoE.apply(mu, logvar, masks)
