"""Hand-written CUDA kernels for the ops the JAX package wrote in Pallas,
each beside its plain PyTorch version (see `_cuda` for the dispatch rule).

    kernel (wrapper)         replaces, in mvae_tpu/ops/
    poe.poe_fwd              poe_pallas.py:_kernel
    elbo.bce_rowsum_fwd      elbo_pallas.py:_kernel
    bn.bn_moments            bn_pallas.py:_k_moments
    bn.bn_normalize          bn_pallas.py:_k_normalize
    bn.bn_bwd_partials       bn_pallas.py:_k_bwd_partials
    bn.bn_dx                 bn_pallas.py:_k_dx
    convbn.conv2d_moments_fwd  convbn_pallas.py:_make_kernel._k

The public ops (`masked_poe_all_terms`, `bce_sum`, `bn_swish_train`,
`conv2d_moments`) are differentiable; the backward of the PoE and the BCE
is closed-form plain PyTorch, as in the JAX package, that of the BN is two
of the kernels, and that of the conv is the stock convolution backward.
"""

from mvae_tpu_torch.ops._cuda import library, plain_versions
from mvae_tpu_torch.ops.bn import (
    bn_bwd_partials, bn_dx, bn_moments, bn_normalize, bn_swish_train)
from mvae_tpu_torch.ops.convbn import conv2d_moments, conv2d_moments_fwd
from mvae_tpu_torch.ops.elbo import bce_rowsum_fwd, bce_rowsum_plain, bce_sum
from mvae_tpu_torch.ops.poe import masked_poe_all_terms, poe_fwd, poe_plain

KERNELS = {"poe_fwd": poe_fwd, "bce_rowsum_fwd": bce_rowsum_fwd,
           "bn_moments": bn_moments, "bn_normalize": bn_normalize,
           "bn_bwd_partials": bn_bwd_partials, "bn_dx": bn_dx,
           "conv2d_moments": conv2d_moments_fwd}


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "bce_rowsum_fwd", "bce_rowsum_plain", "bce_sum",
           "bn_bwd_partials", "bn_dx", "bn_moments", "bn_normalize",
           "bn_swish_train", "conv2d_moments", "conv2d_moments_fwd",
           "launch_counts", "library",
           "masked_poe_all_terms", "plain_versions", "poe_fwd", "poe_plain",
           "reset_launch_counts"]
