"""The port's two kernel ops against the JAX package's Pallas ops.

On the CPU the port's ops run their plain PyTorch versions; the JAX side
runs the Pallas kernels in interpret mode, as tests/test_pallas_kernels.py
does. The CUDA kernels themselves are held against the plain versions on
the card in tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.core.losses import (
    binary_cross_entropy_with_logits as jax_bce_elementwise,
    kl_divergence as jax_kl)
from mvae_tpu.core.poe import masked_product_of_experts as jax_masked_poe
from mvae_tpu.ops.elbo_pallas import bce_sum as jax_bce_sum, bce_sum_ref
from mvae_tpu.ops.poe_pallas import masked_poe_all_terms as jax_poe_all

from mvae_tpu_torch import ops
from mvae_tpu_torch.core import losses
from mvae_tpu_torch.core.poe import masked_product_of_experts
from mvae_tpu_torch.ops.elbo import bce_rowsum_plain
from mvae_tpu_torch.ops.poe import poe_plain

# single f32 ops, same formula: the sums differ only in order (the
# tolerance of tests/test_pallas_kernels.py)
POE_TOL = dict(rtol=1e-5, atol=1e-6)
# 12288-term f32 row sums taken in another order
BCE_TOL = dict(rtol=1e-5, atol=1e-4)


def _poe_inputs(t, m, b, d, seed):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(m, b, d)).astype(np.float32)
    lv = rng.normal(size=(m, b, d)).astype(np.float32)
    masks = (rng.random((t, m)) < 0.6).astype(np.float32)
    masks[0] = 1.0                       # the full-subset term, as in ELBOs
    return mu, lv, masks


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("t,m,b,d", [
    (1, 2, 3, 16),          # serving: one mask row
    (3, 2, 4, 16),          # eval: three terms
    (1, 19, 3, 8),          # celeba19's expert count
    (3, 19, 2, 8),
    (3, 2, 300, 16),        # B*D > 4096: more than one Pallas tile
])
def test_poe_plain_matches_pallas(t, m, b, d):
    mu, lv, masks = _poe_inputs(t, m, b, d, seed=t * 100 + m)
    k_mu, k_lv = jax_poe_all(jnp.asarray(mu), jnp.asarray(lv),
                             jnp.asarray(masks))
    r_mu, r_lv = jax.vmap(jax_masked_poe, in_axes=(None, None, 0))(
        jnp.asarray(mu), jnp.asarray(lv), jnp.asarray(masks))
    p_mu, p_lv = poe_plain(_t(mu), _t(lv), _t(masks))
    d_mu, d_lv = ops.masked_poe_all_terms(_t(mu), _t(lv), _t(masks))
    for got in ((p_mu, p_lv), (d_mu, d_lv)):
        for g, k, r in zip(got, (k_mu, k_lv), (r_mu, r_lv)):
            np.testing.assert_allclose(g.numpy(), np.asarray(k), **POE_TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **POE_TOL)
    # the plain core form, one mask row at a time
    for i in range(t):
        c_mu, c_lv = masked_product_of_experts(_t(mu), _t(lv), _t(masks[i]))
        np.testing.assert_allclose(c_mu.numpy(), np.asarray(r_mu[i]),
                                   **POE_TOL)
        np.testing.assert_allclose(c_lv.numpy(), np.asarray(r_lv[i]),
                                   **POE_TOL)


@pytest.mark.parametrize("n,k", [(12, 18), (4, 12288)])
def test_bce_plain_matches_pallas(n, k):
    rng = np.random.default_rng(k)
    x = rng.normal(scale=3, size=(n, k)).astype(np.float32)
    t = rng.random((n, k)).astype(np.float32)
    want_kernel = np.asarray(jax_bce_sum(jnp.asarray(x), jnp.asarray(t)))
    want_ref = np.asarray(bce_sum_ref(jnp.asarray(x), jnp.asarray(t)))
    for got in (bce_rowsum_plain(_t(x), _t(t)),
                losses.bce_row_sum(_t(x), _t(t))):
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_allclose(got.numpy(), want_kernel, **BCE_TOL)
        np.testing.assert_allclose(got.numpy(), want_ref, **BCE_TOL)


@pytest.mark.parametrize("logits_bf16", [False, True])
def test_bce_bf16_inputs_match_jax_f32_upcast(logits_bf16):
    """bf16 targets (the eval path under bf16 compute) and bf16 logits are
    read as they are and upcast exactly: the result equals JAX on the f32
    upcast of the same bf16 values."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(scale=3, size=(6, 12288))
                         .astype(np.float32))
    t = torch.from_numpy(rng.random((6, 12288)).astype(np.float32))
    t = t.to(torch.bfloat16)
    if logits_bf16:
        x = x.to(torch.bfloat16)
    want = np.asarray(bce_sum_ref(jnp.asarray(x.float().numpy()),
                                  jnp.asarray(t.float().numpy())))
    np.testing.assert_allclose(losses.bce_row_sum(x, t).numpy(), want,
                               **BCE_TOL)


def test_bce_shared_target_rows():
    """T*B logit rows against B target rows equal the repeated targets
    bit for bit, and JAX on the tiled targets within the BCE tolerance."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(scale=3, size=(3 * 4, 96))
                         .astype(np.float32))
    t = torch.from_numpy(rng.random((4, 96)).astype(np.float32))
    shared = losses.bce_row_sum(x, t)
    repeated = losses.bce_row_sum(x, t.repeat(3, 1))
    assert torch.equal(shared, repeated)
    want = np.asarray(bce_sum_ref(jnp.asarray(x.numpy()),
                                  jnp.asarray(np.tile(t.numpy(), (3, 1)))))
    np.testing.assert_allclose(shared.numpy(), want, **BCE_TOL)


def test_elementwise_bce_and_kl_match_jax():
    rng = np.random.default_rng(11)
    x = rng.normal(scale=4, size=(5, 7)).astype(np.float32)
    t = rng.random((5, 7)).astype(np.float32)
    np.testing.assert_allclose(
        losses.binary_cross_entropy_with_logits(_t(x), _t(t)).numpy(),
        np.asarray(jax_bce_elementwise(jnp.asarray(x), jnp.asarray(t))),
        rtol=1e-6, atol=1e-6)
    mu = rng.normal(size=(3, 5, 7)).astype(np.float32)
    lv = rng.normal(size=(3, 5, 7)).astype(np.float32)
    np.testing.assert_allclose(
        losses.kl_divergence(_t(mu), _t(lv)).numpy(),
        np.asarray(jax_kl(jnp.asarray(mu), jnp.asarray(lv))),
        rtol=1e-6, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    """CPU inputs never reach a kernel: the launch counts stay put."""
    before = ops.launch_counts()
    mu, lv, masks = _poe_inputs(3, 2, 4, 8, seed=0)
    ops.masked_poe_all_terms(_t(mu), _t(lv), _t(masks))
    ops.bce_sum(torch.zeros(6, 8), torch.zeros(3, 8))
    assert ops.launch_counts() == before


def test_kernel_wrappers_reject_what_they_do_not_take():
    """The wrappers check before they launch: CPU tensors and target rows
    that do not divide the logit rows raise, as does a device the ops do
    not know."""
    mu, lv, masks = (_t(a) for a in _poe_inputs(1, 2, 3, 4, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        ops.poe_fwd(mu, lv, masks)
    with pytest.raises(ValueError, match="CUDA"):
        ops.bce_rowsum_fwd(torch.zeros(4, 8), torch.zeros(4, 8))
    with pytest.raises(ValueError, match="multiple"):
        ops.bce_rowsum_fwd(torch.zeros(4, 8), torch.zeros(3, 8))
    with pytest.raises(ValueError, match="devices"):
        ops.bce_sum(torch.zeros(4, 8, device="meta"), torch.zeros(4, 8))
