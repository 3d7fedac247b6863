"""Product-of-Experts fusion with the N(0, I) prior folded in (counterpart
of mvae_tpu/core/poe.py).

    T_i  = 1 / (exp(logvar_i) + eps)
    mu*  = sum_i mask_i mu_i T_i / (sum_i mask_i T_i + T_prior)
    var* = 1 / (sum_i mask_i T_i + T_prior),   T_prior = 1 / (1 + eps)

A 0 in the mask removes an expert exactly. The paths fuse through
ops.masked_poe_all_terms, which runs every mask row in one kernel launch;
this is its single-row form.
"""

from mvae_tpu_torch.ops.poe import poe_plain


def masked_product_of_experts(mu, logvar, mask):
    """mu, logvar: (M, B, D); mask: (M,) -> (pd_mu, pd_logvar), each
    (B, D). The plain version of the PoE kernel with one mask row."""
    pd_mu, pd_logvar = poe_plain(mu, logvar, mask[None])
    return pd_mu[0], pd_logvar[0]
