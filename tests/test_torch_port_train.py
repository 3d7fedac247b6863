"""The port's training path against the JAX package on the CPU: the BN
op (the JAX side runs its Pallas kernels in interpret mode, as
tests/test_bn_pallas.py does), the autograd of the PoE and the BCE, the
EMA commit, the train-mode ELBO with its gradients, a K=3 window of
`make_multi_train_step`, and the bf16 step. Same weights
(`state_dict_from_jax`), same batch, and the JAX package's own noise: eps
and the dropout keep-mask are drawn here from the keys `multi_term_elbo`
splits (engine.py:215, sampling.py:16, layers.py:32) and handed to the
port."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mvae_tpu.ops.bn_pallas as jax_bn_pallas
from mvae_tpu.core.anneal import (
    annealing_factor as jax_annealing_factor,
    annealing_factor_from_step as jax_annealing_from_step)
from mvae_tpu.core.engine import multi_term_elbo as jax_multi_term_elbo
from mvae_tpu.nn.layers import dropout as jax_dropout
from mvae_tpu.ops.elbo_pallas import bce_sum as jax_bce_sum
from mvae_tpu.ops.poe_pallas import masked_poe_all_terms as jax_poe_all
from mvae_tpu.train.loop import (
    decode_batch as jax_decode_batch,
    make_multi_train_step as jax_make_multi_train_step)

from mvae_tpu_torch import ops
from mvae_tpu_torch.core.anneal import (
    annealing_factor, annealing_factor_from_step)
from mvae_tpu_torch.core.engine import commit_ema_states, multi_term_elbo
from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.nn.layers import dropout
from mvae_tpu_torch.nn.norm import BatchNorm, BNSwishSequential, Moments
from mvae_tpu_torch.ops.bn import (
    EPS, bn_bwd_partials_plain, bn_dx_plain, bn_moments_plain,
    bn_normalize_plain, bn_swish_bwd_plain, bn_swish_fwd_plain,
    bn_swish_train)
from mvae_tpu_torch.train.loop import (
    decode_batch, draw_noise, make_multi_train_step, make_train_step)
from mvae_tpu_torch.utils.weights import state_dict_from_jax

from tests.test_torch_port_modules import (
    L, celeba_batch, jax_celeba, port_celeba, rel_l1)

MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3        # the CelebA CLI's weights
B = 6
LR = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_noise(key, t, b):
    """The noise multi_term_elbo draws from `key`: the image head's
    dropout keep-mask (rngs[0]) and eps (rngs[1])."""
    rngs = jax.random.split(key, 3)
    keep = jax.random.bernoulli(rngs[0], 0.9, (b, 512))
    eps = jax.random.normal(rngs[1], (t, b, L), jnp.float32)
    return np.asarray(eps), np.asarray(keep)


# --------------------------------------------------------------------------
# BN op
# --------------------------------------------------------------------------

def _bn_inputs(g, n, c, hw, dtype, seed):
    rng = np.random.default_rng(seed)
    shape = (g, n) + ((hw, hw) if hw else ()) + (c,)
    x = rng.normal(0.5, 1.5, shape).astype(np.float32)
    ct = rng.normal(0.0, 1.0, shape).astype(np.float32)
    scale = rng.normal(1.0, 0.2, c).astype(np.float32)
    bias = rng.normal(0.0, 0.2, c).astype(np.float32)
    if dtype == "bfloat16":   # round once, so both sides read one value
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        ct = np.asarray(jnp.asarray(ct, jnp.bfloat16).astype(jnp.float32))
    return x, ct, scale, bias


def _to_port(a, hw):
    """(G, N, [H, W,] C) channels-last -> (G*N, C[, H, W]) contiguous."""
    a = a.reshape((-1,) + a.shape[2:])
    if hw:
        a = np.transpose(a, (0, 3, 1, 2))
    return torch.tensor(np.ascontiguousarray(a))


def _from_port(t, g, hw):
    a = t.detach().float().numpy()
    if hw:
        a = np.transpose(a, (0, 2, 3, 1))
    return a.reshape((g, -1) + a.shape[1:])


# f32: one op, the same formula in another summation order, and the JAX
# side normalizes (x - mean) * invstd where the port forms x * a + b
BN_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 y and dx: both round an f32 value once to bf16; the f32 values
# differ in their last bits, which moves a rare rounding by one bf16 step
# (2^-8 relative)
BN_BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
# dx, dscale, dbias in f32: sums over up to 24*8*8 elements whose
# cancellations (BN's backward subtracts the mean terms) leave them small
BN_GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,n,c,hw", [
    (1, 6, 64, 8),          # the encoder's BN'd convs: C < 128, folded lanes
    (1, 4, 256, 5),         # C > 128, 5x5
    (3, 4, 32, 8),          # the decoder's BNs over three terms
    (1, 12, 512, 0),        # BatchNorm1d, (N, C)
    (3, 8, 512, 0),
    (2, 5, 12, 0),          # S = 1, C off every chunk width, two groups
    (1, 3, 40, 5),          # S = 25, C off the 128 lanes: JAX's ragged view
])
def test_bn_swish_train_matches_pallas(g, n, c, hw, dtype):
    """y, mean, var and the gradients of x, scale, bias against the JAX
    package's Pallas op (G = 1: the plain call; G = 3: vmap over the term
    axis, the statistics the engine's vmap gives). The port runs NCHW and
    the plain versions here, through the op's autograd. Then the plain
    versions of the two passes that do the per-channel algebra, from the
    sums, against the JAX op's own forward and VJP (_fwd_impl: y, mean,
    var, a, b, invstd; _vjp_bwd: dx and, summed over the groups, dscale
    and dbias)."""
    x, ct, scale, bias = _bn_inputs(g, n, c, hw, dtype, seed=g * 1000 + c)
    jdt = getattr(jnp, dtype)

    def jax_op(xg, s, b):
        return jax_bn_pallas.bn_swish_train(xg, s, b)

    def jax_loss(xx, s, b):
        y, _, _ = jax.vmap(jax_op, in_axes=(0, None, None))(xx, s, b)
        return jnp.vdot(y.astype(jnp.float32), jnp.asarray(ct))

    jx = jnp.asarray(x, jdt)
    if g == 1:
        jy, jm, jv = jax_op(jx[0], jnp.asarray(scale), jnp.asarray(bias))
        jy, jm, jv = jy[None], jm[None], jv[None]
    else:
        jy, jm, jv = jax.vmap(jax_op, in_axes=(0, None, None))(
            jx, jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jx, jnp.asarray(scale), jnp.asarray(bias))

    px = _to_port(x, hw).to(getattr(torch, dtype)).requires_grad_(True)
    ps = torch.from_numpy(scale).requires_grad_(True)
    pb = torch.from_numpy(bias).requires_grad_(True)
    y, mean, var = bn_swish_train(px, ps, pb, groups=g)
    assert y.dtype == px.dtype and y.shape == px.shape
    assert mean.shape == var.shape == (g, c) and mean.dtype == torch.float32
    assert not mean.requires_grad and not var.requires_grad
    y.backward(_to_port(ct, hw).to(y.dtype))
    tol = BN_TOL if dtype == "float32" else BN_BF16_TOL
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), **BN_TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jv), **BN_TOL)
    np.testing.assert_allclose(_from_port(y, g, hw),
                               np.asarray(jy.astype(jnp.float32)), **tol)
    gtol = BN_GRAD_TOL if dtype == "float32" else BN_BF16_TOL
    np.testing.assert_allclose(_from_port(px.grad, g, hw),
                               np.asarray(jdx.astype(jnp.float32)), **gtol)
    np.testing.assert_allclose(ps.grad.numpy(), np.asarray(jds),
                               **BN_GRAD_TOL)
    np.testing.assert_allclose(pb.grad.numpy(), np.asarray(jdb),
                               **BN_GRAD_TOL)

    # the composed plain versions give the op's values bit for bit
    x4 = px.detach().view(g, n, c, -1)
    g4 = _to_port(ct, hw).to(px.dtype).view(g, n, c, -1)
    fy, fm, fv = bn_swish_fwd_plain(x4, ps.detach(), pb.detach())
    assert torch.equal(fy.view(y.shape), y) and torch.equal(fm, mean)
    assert torch.equal(fv, var)
    dx, ds, db = bn_swish_bwd_plain(x4, g4, ps.detach(), pb.detach())
    assert torch.equal(dx.view(px.shape), px.grad)
    assert torch.equal(ds, ps.grad) and torch.equal(db, pb.grad)

    js, jb = jnp.asarray(scale), jnp.asarray(bias)
    fy, fmean, fvar, (fa, fb, fmean2, finv) = jax.vmap(
        lambda xg: jax_bn_pallas._fwd_impl(xg, js, jb, EPS))(jx)
    s, q = bn_moments_plain(x4)
    count = x4.shape[1] * x4.shape[3]
    out = bn_normalize_plain(x4, s, q, count, ps.detach(), pb.detach())
    np.testing.assert_allclose(_from_port(out[0].view(px.shape), g, hw),
                               np.asarray(fy.astype(jnp.float32)), **tol)
    for got, want in zip(out[1:], (fmean, fvar, fa, fb, finv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BN_TOL)
    zeros = jnp.zeros((c,), jnp.float32)
    bdx, bds, bdb = jax.vmap(
        lambda xg, a, b, m, i, gg: jax_bn_pallas._vjp_bwd(
            EPS, (xg, js, a, b, m, i), (gg, zeros, zeros)))(
        jx, fa, fb, fmean2, finv, jnp.asarray(ct, jdt))
    _, mean_, _, a_, b_, inv_ = out
    sdz, sdzx = bn_bwd_partials_plain(x4, g4, a_, b_)
    dx, ds, db = bn_dx_plain(x4, g4, sdz, sdzx, count, a_, b_, mean_, inv_)
    np.testing.assert_allclose(_from_port(dx.view(px.shape), g, hw),
                               np.asarray(bdx.astype(jnp.float32)), **gtol)
    np.testing.assert_allclose(ds.numpy(), np.asarray(bds.sum(0)),
                               **BN_GRAD_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(bdb.sum(0)),
                               **BN_GRAD_TOL)


def test_bn_train_mode_fuses_the_following_swish():
    """A train-mode BN applies swish itself and the Sequential skips the
    Swish module after it; eval mode runs BN then Swish. The moments land
    on the module for the commit and the running buffers do not move."""
    from mvae_tpu_torch.nn.layers import Swish
    bn = BatchNorm(5, device="cpu")
    bn.reset_parameters()
    seq = BNSwishSequential(bn, Swish())
    x = torch.randn(6, 5, generator=torch.Generator().manual_seed(0))
    seq.train()
    y = seq(x)
    want, mean, _ = bn_swish_train(x, bn.weight, bn.bias)
    assert torch.equal(y, want)
    assert bn.moments.n == 6 and torch.equal(bn.moments.mean, mean)
    assert torch.equal(bn.running_mean, torch.zeros(5))
    seq.eval()
    xn = x / torch.sqrt(torch.tensor(1.0 + 1e-5))
    torch.testing.assert_close(seq(x), xn * torch.sigmoid(xn))
    with pytest.raises(ValueError, match="fused"):
        BNSwishSequential(BatchNorm(5, device="cpu"))


# --------------------------------------------------------------------------
# autograd of the PoE and the BCE
# --------------------------------------------------------------------------

# the closed forms of both sides in f32, the same formula; the PoE's mask
# contraction is a matmul here and an einsum there
GRAD_OP_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t,m,b,d,masks", [
    (3, 2, 5, L, MASKS),    # the CelebA terms
    (1, 2, 3, 16, None),    # serving: one mask row
    (3, 2, 4, 16, None),    # eval: three terms
    (1, 19, 3, 8, None),    # celeba19's expert count
    (3, 19, 2, 8, None),
    (3, 2, 300, 16, None),  # B*D > 4096: more than one Pallas tile
    (2, 3, 4, 16, [[1.0, 0.5, 0.25], [0.0, 2.0, 1.0]]),   # float weights
])
def test_poe_gradients_match_jax(t, m, b, d, masks):
    """poe_bwd_plain, called directly and as the op's backward on the CPU,
    against jax.grad through the Pallas op (interpret mode) and its
    closed-form VJP, at the cases of the forward's test
    (test_torch_port_kernels.py:test_poe_plain_matches_pallas)."""
    rng = np.random.default_rng(21)
    mu = rng.normal(size=(m, b, d)).astype(np.float32)
    lv = rng.normal(size=(m, b, d)).astype(np.float32)
    if masks is None:
        masks = (rng.random((t, m)) < 0.6).astype(np.float32)
        masks[0] = 1.0
    masks = np.asarray(masks, np.float32)
    w_mu = rng.normal(size=(t, b, d)).astype(np.float32)
    w_lv = rng.normal(size=(t, b, d)).astype(np.float32)

    def jax_loss(m_, v_):
        a, b_ = jax_poe_all(m_, v_, jnp.asarray(masks))
        return jnp.vdot(a, w_mu) + jnp.vdot(b_, w_lv)

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(mu),
                                              jnp.asarray(lv))
    pm, pv = _t(mu).requires_grad_(True), _t(lv).requires_grad_(True)
    a, b_ = ops.masked_poe_all_terms(pm, pv, _t(masks))
    ((a * _t(w_mu)).sum() + (b_ * _t(w_lv)).sum()).backward()
    direct = ops.poe_bwd_plain(_t(mu), _t(lv), _t(masks), _t(w_mu),
                               _t(w_lv))
    for got, plain, w in zip((pm.grad, pv.grad), direct, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_OP_TOL)
        np.testing.assert_allclose(plain.numpy(), np.asarray(w),
                                   **GRAD_OP_TOL)


@pytest.mark.parametrize("logits_dtype", ["float32", "bfloat16"])
def test_bce_gradients_match_jax(logits_dtype):
    """3 groups of 4 logit rows share 4 target rows. The logits' gradient
    comes back in the logits' dtype: in bf16 it is JAX's f32 gradient on
    the same (upcast) values, rounded once. The targets' gradient sums over
    the groups (JAX: on the tiled targets, then summed)."""
    rng = np.random.default_rng(22)
    x = rng.normal(scale=3, size=(12, 96)).astype(np.float32)
    if logits_dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    t = rng.random((4, 96)).astype(np.float32)
    w = rng.normal(size=12).astype(np.float32)
    jgx, jgt = jax.grad(lambda a, b: jnp.vdot(jax_bce_sum(a, b), w),
                        argnums=(0, 1))(jnp.asarray(x),
                                        jnp.asarray(np.tile(t, (3, 1))))
    px = _t(x).to(getattr(torch, logits_dtype)).requires_grad_(True)
    pt = _t(t).requires_grad_(True)
    (ops.bce_sum(px, pt) * _t(w)).sum().backward()
    assert px.grad.dtype == px.dtype
    want_x = np.asarray(jgx)
    if logits_dtype == "bfloat16":
        want_x = np.asarray(jnp.asarray(want_x, jnp.bfloat16)
                            .astype(jnp.float32))
        np.testing.assert_allclose(px.grad.float().numpy(), want_x,
                                   **BN_BF16_TOL)
    else:
        np.testing.assert_allclose(px.grad.numpy(), want_x, **GRAD_OP_TOL)
    np.testing.assert_allclose(
        pt.grad.numpy(), np.asarray(jgt).reshape(3, 4, 96).sum(0),
        rtol=1e-5, atol=1e-5)


def test_bce_targets_take_no_gradient_unless_asked():
    x = torch.randn(6, 8, requires_grad=True)
    t = torch.rand(3, 8)
    ops.bce_sum(x, t).sum().backward()
    assert x.grad is not None and t.grad is None


# --------------------------------------------------------------------------
# dropout, annealing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_jax(dtype):
    """where(mask, x / keep, 0) with JAX's mask, keep rounded to x's dtype
    as JAX's weakly typed scalar is: equal bit for bit."""
    key = jax.random.key(3)
    x = np.random.default_rng(3).normal(size=(4, 512)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jax_dropout(key, jx, 0.1, True)
    mask = np.asarray(jax.random.bernoulli(key, 0.9, (4, 512)))
    got = dropout(_t(x).to(getattr(torch, dtype)), _t(mask), 0.1)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_annealing_matches_jax():
    for epoch in (1, 2, 5, 20, 21):
        for idx in (0, 3, 9):
            assert annealing_factor(epoch, idx, 10, 20) == \
                jax_annealing_factor(epoch, idx, 10, 20)
    steps = np.arange(0, 260, 7)
    want = np.asarray(jax_annealing_from_step(jnp.asarray(steps), 10, 20))
    got = annealing_factor_from_step(torch.from_numpy(steps), 10, 20)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert [annealing_factor_from_step(int(s), 10, 20) for s in steps] == \
        pytest.approx(list(want), rel=1e-6)


# --------------------------------------------------------------------------
# the train-mode ELBO, the EMA commit, the K-step window
# --------------------------------------------------------------------------

def _uint8_data(n, seed):
    return celeba_batch(n, seed, uint8=True)


def _jax_elbo(jm, params, state, batch_u8, key, dtype=jnp.float32):
    batch = jax_decode_batch({k: jnp.asarray(v) for k, v in
                              batch_u8.items()}, dtype)

    def loss(p):
        total, aux, new_state = jax_multi_term_elbo(
            jm, p, state, batch, jnp.asarray(MASKS), jnp.asarray(LAMBDAS),
            key, 0.7, train=True)
        return total, (aux["per_term"], new_state)

    (total, (per_term, new_state)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return float(total), np.asarray(per_term), grads, new_state


def _port_elbo(pm, batch_u8, noise, dtype=torch.float32):
    pm.train()
    pm.zero_grad(set_to_none=True)
    batch = decode_batch({k: torch.from_numpy(v) for k, v in
                          batch_u8.items()}, dtype)
    total, aux = multi_term_elbo(
        pm, batch, torch.tensor(MASKS), torch.tensor(LAMBDAS), 0.7,
        train=True, noise=tuple(_t(a) for a in noise))
    total.backward()
    return total.detach(), aux["per_term"].detach()


def _grads_sd(pm):
    return {k: p.grad.numpy() for k, p in pm.named_parameters()}


def _jax_grads_sd(grads, state, pm):
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                             state)
    return {k: sd[k] for k, _ in pm.named_parameters()}


# The Linear biases that feed a BatchNorm: BN subtracts the batch mean, so
# their exact gradient is 0 and both sides return rounding noise (norm
# about 3e-6 here against 1 to 2000 for the other gradients).
BN_FED_BIASES = ("attrs_encoder.net.0.bias", "attrs_encoder.net.3.bias",
                 "attrs_decoder.net.0.bias", "attrs_decoder.net.3.bias",
                 "attrs_decoder.net.6.bias")


def _fed_by_noisy_bias(key):
    """A BN running mean that tracks one of BN_FED_BIASES."""
    mod, idx, name = key.rsplit(".", 2)
    return (name == "running_mean"
            and f"{mod}.{int(idx) - 1}.bias" in BN_FED_BIASES)


def _grads_close(got, want, rtol, noise_atol):
    """Each gradient within rtol of JAX's in Frobenius norm; the ones that
    are exactly 0 in exact arithmetic within noise_atol of it."""
    assert set(BN_FED_BIASES) < set(want)
    for k in want:
        gap = float(np.linalg.norm(got[k] - want[k]))
        if k in BN_FED_BIASES:
            assert gap < noise_atol, (k, gap)
        else:
            assert gap < rtol * float(np.linalg.norm(want[k])), (k, gap)


@pytest.fixture(scope="module")
def f32_step():
    """One train-mode ELBO in f32 on both sides, from the same weights,
    batch and JAX noise."""
    jm, params, state = jax_celeba()
    batch = _uint8_data(B, 31)
    key = jax.random.key(7)
    want = _jax_elbo(jm, params, state, batch, key)
    pm = port_celeba(params, state)
    got = _port_elbo(pm, batch, jax_noise(key, 3, B))
    return want, got, pm, params


def test_train_elbo_f32_matches_jax(f32_step):
    """Total and per-term values at rtol 1e-4, the golden tolerance of a
    whole multi-term ELBO. Gradients: each within 5e-5 of JAX's in
    relative Frobenius norm (conv nets summed in another order; the
    largest gap read 5.5e-6), the BN-fed biases within 2e-5 of 0's noise
    (read: 3.9e-6 at most)."""
    (w_total, w_terms, grads, state), (total, per_term), pm, _ = f32_step
    np.testing.assert_allclose(float(total), w_total, rtol=1e-4)
    np.testing.assert_allclose(per_term.numpy(), w_terms, rtol=1e-4)
    _grads_close(_grads_sd(pm), _jax_grads_sd(grads, state, pm),
                 rtol=5e-5, noise_atol=2e-5)


def test_commit_ema_states_matches_jax(f32_step):
    """The running statistics after the step against JAX's new_state:
    decoders committed T = 3 times, each encoder k = 2 times."""
    (_, _, _, new_state), _, pm, params = f32_step
    want = state_dict_from_jax(
        params, jax.tree_util.tree_map(np.asarray, new_state))
    sd = pm.state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 22
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_commit_folds_sequential_commits():
    """The closed forms equal T sequential torch-style EMA commits (each
    decoder term in order; the encoder's k identical ones)."""
    rng = np.random.default_rng(8)
    dec, enc = BatchNorm(4, device="cpu"), BatchNorm(4, device="cpu")
    for bn in (dec, enc):
        bn.reset_parameters()
        bn.running_mean.copy_(_t(rng.normal(size=4).astype(np.float32)))
    mean = _t(rng.normal(size=(3, 4)).astype(np.float32))
    var = _t(rng.random((3, 4)).astype(np.float32))
    want_m, want_v = dec.running_mean.clone(), dec.running_var.clone()
    for t in range(3):
        want_m = 0.9 * want_m + 0.1 * mean[t]
        want_v = 0.9 * want_v + 0.1 * var[t] * 10 / 9
    enc_m, enc_v = enc.running_mean.clone(), enc.running_var.clone()
    for _ in range(2):
        enc_m = 0.9 * enc_m + 0.1 * mean[0]
        enc_v = 0.9 * enc_v + 0.1 * var[0] * 10 / 9

    class M:
        modalities = ("image", "attrs")
        modality_index = staticmethod(("image", "attrs").index)

    commit_ema_states(M(), {"attrs": [Moments(enc, mean[:1], var[:1], 10)]},
                      [Moments(dec, mean, var, 10)], torch.tensor(MASKS))
    for got, want in ((dec.running_mean, want_m), (dec.running_var, want_v),
                      (enc.running_mean, enc_m), (enc.running_var, enc_v)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_window_of_three_steps_matches_jax():
    """K = 3 steps of make_multi_train_step against the JAX package's, f32,
    Adam(1e-4) from zero state on both sides, the same idxs and the JAX
    noise chain (r, sub = split(r) per step). The (3,) losses at rtol
    1e-4; BN running statistics at rtol 1e-4. Params: Adam's first steps
    move each weight by about lr whatever its gradient's size, so a weight
    whose gradient is rounding noise can step either way. The BN-fed
    biases' gradients are all noise (see BN_FED_BIASES): they are held
    within 2 * lr * K of JAX, and so is the running mean of the BN each
    feeds, which tracks that bias. In every other tensor a few elements
    have near-0 gradients: its gap to JAX is held below 2e-3 of the
    distance it moved (Frobenius norms; the largest read 4.8e-4, the
    classifier's first weight, where 3e-6 of the elements differ).
    """
    jm, params, state = jax_celeba()
    data = _uint8_data(10, 41)
    idxs = np.asarray([[3, 1, 4, 1, 5, 9], [2, 6, 5, 3, 5, 8],
                       [9, 7, 9, 3, 2, 3]])
    betas = np.asarray([0.2, 0.5, 1.0], np.float32)
    tx = optax.adam(LR)
    multi = jax_make_multi_train_step(jm, tx, MASKS, LAMBDAS)
    rng = jax.random.key(11)
    j_params, j_state, _, _, j_losses = multi(
        params, state, tx.init(params), rng,
        {k: jnp.asarray(v)[None] for k, v in data.items()},
        jnp.asarray(idxs)[:, None, :], jnp.asarray(betas))

    noise, r = [], rng
    for _ in range(3):
        r, sub = jax.random.split(r)
        noise.append(jax_noise(sub, 3, B))
    pm = port_celeba(params, state)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    step = make_multi_train_step(pm, MASKS, LAMBDAS, lr=LR,
                                 generator=torch.Generator(), device="cpu")
    losses = step({k: torch.from_numpy(v) for k, v in data.items()},
                  torch.from_numpy(idxs), torch.from_numpy(betas),
                  noise=(torch.from_numpy(np.stack([n[0] for n in noise])),
                         torch.from_numpy(np.stack([n[1] for n in noise]))))
    assert losses.shape == (3,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses),
                               rtol=1e-4)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_params),
                               jax.tree_util.tree_map(np.asarray, j_state))
    sd = pm.state_dict()
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 0, k
        elif k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                v.numpy(), want[k], rtol=1e-4,
                atol=2 * LR * 3 if _fed_by_noisy_bias(k) else 1e-6,
                err_msg=k)
        elif k in BN_FED_BIASES:
            assert np.abs(v.numpy() - want[k]).max() < 2 * LR * 3, k
        else:
            moved = np.linalg.norm(want[k] - before[k].numpy())
            gap = np.linalg.norm(v.numpy() - want[k])
            assert moved > 0 and gap < 2e-3 * moved, (k, gap / moved)


# --------------------------------------------------------------------------
# bf16
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_readings():
    """One train-mode ELBO under bf16 compute on the JAX side (its Pallas
    BN path, interpret mode), the port in bf16 and the port in f32, from
    one set of weights, batch and noise."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_bn_pallas, "use_pallas_bn", lambda: True)
    try:
        jm, params, state = jax_celeba(compute_dtype=jnp.bfloat16)
        batch = _uint8_data(B, 51)
        key = jax.random.key(13)
        want = _jax_elbo(jm, params, state, batch, key, jnp.bfloat16)
    finally:
        mp.undo()
    noise = jax_noise(key, 3, B)
    pb = port_celeba(params, state, compute_dtype=torch.bfloat16)
    got_b = _port_elbo(pb, batch, noise, torch.bfloat16)
    pf = port_celeba(params, state)
    got_f = _port_elbo(pf, batch, noise)
    return want, (got_b, pb), (got_f, pf)


# bf16 compute, one train-mode ELBO. rel_l1 of the port in bf16 against two
# references on one set of weights, batch and noise: the JAX package in
# bf16 through its Pallas BN (rounding flips where the two sum in another
# order, propagated) and the port in f32 (every bf16 rounding point). Each
# limit lies between the two readings, so a cast point out of place, or a
# bf16 BN that keeps its output in f32, fails. The readings on weight
# seeds 0, 1, 2 (CPU):
#   reading                        vs JAX                 vs f32
#   total (relative)               1.4e-6 1.6e-6 3.2e-7   4.7e-5 7.2e-6 6.6e-5
#   grad hallucinate.9.weight      6.8e-4 7.5e-4 7.5e-4   1.0e-2 9.9e-3 9.7e-3
#   grad hallucinate.7.weight (BN) 2.0e-4 2.2e-4 2.2e-4   3.5e-3 2.9e-3 2.7e-3
#   grad hallucinate.7.bias (BN)   1.8e-4 2.0e-4 1.2e-4   9.6e-3 7.1e-3 5.8e-3
#   hallucinate.7.running_mean     5.9e-6 7.0e-6 8.1e-6   8.6e-5 1.1e-4 1.1e-4
#   features.3.running_var         4.9e-8 4.7e-8 5.6e-8   8.4e-7 5.1e-7 4.9e-7
BF16_STEP_LIMITS = {
    "total": 4e-6,
    "grad image_decoder.hallucinate.9.weight": 3e-3,
    "grad image_decoder.hallucinate.7.weight": 8e-4,
    "grad image_decoder.hallucinate.7.bias": 1e-3,
    "image_decoder.hallucinate.7.running_mean": 3e-5,
    "image_encoder.features.3.running_var": 2e-7,
}


@pytest.mark.parametrize("reading", sorted(BF16_STEP_LIMITS))
def test_bf16_step_between_its_readings(bf16_readings, reading):
    """The bf16 train step's loss, the gradients of the image decoder's
    last BN and logits layer, and running statistics after the commit:
    closer to JAX in bf16 than the limit, farther from the port in f32."""
    (w_total, _, grads, state), ((total_b, _), pb), ((total_f, _), pf) = \
        bf16_readings
    if reading == "total":
        to_jax = abs(float(total_b) / w_total - 1)
        to_f32 = abs(float(total_b) / float(total_f) - 1)
    elif reading.startswith("grad "):
        k = reading.split()[1]
        got = pb.get_parameter(k).grad.numpy()
        to_jax = rel_l1(got, _jax_grads_sd(grads, state, pb)[k])
        to_f32 = rel_l1(got, pf.get_parameter(k).grad.numpy())
    else:
        want = state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, grads),
            jax.tree_util.tree_map(np.asarray, state))[reading]
        got = pb.state_dict()[reading].numpy()
        to_jax = rel_l1(got, want)
        to_f32 = rel_l1(got, pf.state_dict()[reading].numpy())
    limit = BF16_STEP_LIMITS[reading]
    assert to_jax < limit < to_f32, (reading, to_jax, limit, to_f32)


# --------------------------------------------------------------------------
# the step's own noise and input paths
# --------------------------------------------------------------------------

def test_draw_noise_shapes_and_rate():
    model = CelebaMVAE(L, device="cpu")
    eps, keep = draw_noise(model, 3, 200, torch.Generator().manual_seed(0))
    assert eps.shape == (3, 200, L) and eps.dtype == torch.float32
    assert keep.shape == (200, 512) and keep.dtype == torch.bool
    assert abs(keep.float().mean().item() - 0.9) < 0.01
    assert abs(eps.mean().item()) < 0.05 and abs(eps.std().item() - 1) < 0.05


def _steps(seed, device_data, n_steps=2):
    model = CelebaMVAE(L, device="cpu")
    step = make_train_step(model, MASKS, LAMBDAS, lr=LR, device="cpu",
                           generator=torch.Generator().manual_seed(seed),
                           device_data=device_data)
    data = {k: torch.from_numpy(v) for k, v in _uint8_data(8, 61).items()}
    idx = torch.tensor([5, 0, 3, 3])
    losses = []
    for _ in range(n_steps):
        batch = (data, idx) if device_data else {
            k: v[idx] for k, v in data.items()}
        loss, per_term = step(batch, 1.0)
        assert per_term.shape == (3,) and not loss.requires_grad
        losses.append(float(loss))
    return losses, model.state_dict()


def test_train_step_draws_from_its_generator():
    """The same generator seed gives the same steps bit for bit, whether the
    step gathers its rows on the device or is handed them; another seed
    gives another draw. The optimizer is the step's own Adam."""
    a_loss, a_sd = _steps(0, device_data=True)
    b_loss, b_sd = _steps(0, device_data=False)
    c_loss, _ = _steps(1, device_data=True)
    assert a_loss == b_loss and a_loss != c_loss
    for k in a_sd:
        assert torch.equal(a_sd[k], b_sd[k]), k
    model = CelebaMVAE(L, device="cpu")
    step = make_train_step(model, MASKS, LAMBDAS, lr=LR, device="cpu",
                           generator=torch.Generator())
    opt = step.optimizer
    assert isinstance(opt, torch.optim.Adam)
    assert opt.defaults["betas"] == (0.9, 0.999)
    assert opt.defaults["eps"] == 1e-8
