"""Hand-written CUDA kernels for the ops the JAX package wrote in Pallas,
each beside its plain PyTorch version (see `_cuda` for the dispatch rule).

    kernel            replaces                           wrapper
    poe_fwd           mvae_tpu/ops/poe_pallas.py:_kernel   ops.poe.poe_fwd
    bce_rowsum_fwd    mvae_tpu/ops/elbo_pallas.py:_kernel  ops.elbo.bce_rowsum_fwd
"""

from mvae_tpu_torch.ops._cuda import library, plain_versions
from mvae_tpu_torch.ops.elbo import bce_rowsum_fwd, bce_rowsum_plain, bce_sum
from mvae_tpu_torch.ops.poe import masked_poe_all_terms, poe_fwd, poe_plain

KERNELS = {"poe_fwd": poe_fwd, "bce_rowsum_fwd": bce_rowsum_fwd}


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "bce_rowsum_fwd", "bce_rowsum_plain", "bce_sum",
           "launch_counts", "library", "masked_poe_all_terms",
           "plain_versions", "poe_fwd", "poe_plain", "reset_launch_counts"]
