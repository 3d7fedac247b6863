"""The port's fused conv + BN-moments route against the JAX package's on
the CPU: the op (ops/convbn.py:conv2d_moments against
mvae_tpu/ops/convbn_pallas.py:conv2d_moments, whose Pallas kernel runs in
interpret mode here, as tests/test_convbn_pallas.py runs it), the encoder's
ConvStack in train mode, and a whole f32 train step of CelebaMVAE(8).

The JAX side never takes the fused route on its own under this conftest:
`use_convbn_pallas()` needs MVAE_CONVBN_PALLAS=1 and exactly one JAX
device, and the conftest forces eight. So these tests patch
`mvae_tpu.nn.dcgan._convbn_pallas` to True and count the calls of
`conv2d_moments` to show the route was taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvae_tpu.nn.dcgan as jax_dcgan
import mvae_tpu.ops.bn_pallas as jax_bn_pallas
import mvae_tpu.ops.convbn_pallas as jax_convbn
from mvae_tpu.models.celeba import ENC_SPECS

from mvae_tpu_torch.models.celeba import ENC_SPECS as PORT_ENC_SPECS
from mvae_tpu_torch.nn.dcgan import ConvStack
from mvae_tpu_torch.ops.convbn import (
    conv2d_moments, conv2d_moments_plain, supported)
from mvae_tpu_torch.utils.weights import state_dict_from_jax

from tests.test_torch_port_modules import (
    jax_celeba, nchw, port_celeba, rel_l1)
from tests.test_torch_port_train import (
    B, BN_FED_BIASES, _grads_close, _grads_sd, _jax_elbo, _jax_grads_sd,
    _port_elbo, _uint8_data, jax_noise)

# f32 y: both sides sum up to 2048 products in another order (oneDNN vs
# XLA); the sums of the rounded y over a few hundred pixels
Y_F32_TOL = dict(rtol=1e-5, atol=1e-5)
SUM_F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 y: both round an f32 accumulator once, so a rare y sits one bf16
# step apart (2^-7 relative at most; 2 of 6144 values here); the sums then
# move by that step times the few such values
Y_BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)
SUM_BF16_TOL = dict(rtol=1e-3, atol=1e-2)
# gradients of a loss through (y, s, q), f32
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# (B, H, C_in, C_out, stride, padding): the CelebA encoder's BN'd convs at
# a small batch and narrow maps, and the first layer's three channels
CASES = {"conv2": (3, 16, 32, 64, 2, 1), "conv3": (3, 8, 64, 128, 2, 1),
         "conv4": (3, 8, 128, 256, 1, 0), "rgb": (2, 6, 3, 8, 2, 1)}


def _inputs(case, dtype, seed=0):
    """x NHWC in [0, 2), w HWIO at the kaiming scale, rounded once to
    dtype so both sides read one value; and the port's NCHW / OIHW."""
    b, h, c_in, c_out, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    jx = jnp.asarray(2 * rng.random((b, h, h, c_in)), dtype)
    jw = jnp.asarray(rng.normal(size=(4, 4, c_in, c_out))
                     / np.sqrt(16 * c_in), dtype)
    tdt = getattr(torch, jnp.dtype(dtype).name)
    px = nchw(np.asarray(jx.astype(jnp.float32))).to(tdt)
    pw = torch.from_numpy(np.ascontiguousarray(np.transpose(
        np.asarray(jw.astype(jnp.float32)), (3, 2, 0, 1)))).to(tdt)
    return jx, jw, px, pw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_conv2d_moments_matches_jax(case, dtype):
    """y, sum y and sum y^2 against the Pallas op (interpret mode); the
    plain version and the differentiable op give one value; the op hands y
    back in f32, its values those of y in x's dtype."""
    *_, stride, pad = CASES[case]
    jx, jw, px, pw = _inputs(case, getattr(jnp, dtype))
    jy, js, jq = jax_convbn.conv2d_moments(jx, jw, stride, pad)
    y, s, q = conv2d_moments(px, pw, stride, pad)
    assert y.dtype == s.dtype == q.dtype == torch.float32
    py, ps, pq = conv2d_moments_plain(px, pw, stride, pad)
    assert py.dtype == px.dtype and torch.equal(y, py.float())
    assert torch.equal(s, ps) and torch.equal(q, pq)
    want_y = np.transpose(np.asarray(jy.astype(jnp.float32)), (0, 3, 1, 2))
    assert y.shape == want_y.shape
    f32 = dtype == "float32"
    np.testing.assert_allclose(y.to(px.dtype).float().numpy(), want_y,
                               **(Y_F32_TOL if f32 else Y_BF16_TOL))
    for got, want in ((s, js), (q, jq)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **(SUM_F32_TOL if f32 else SUM_BF16_TOL))


@pytest.mark.parametrize("case", ["conv2", "conv4"])
def test_conv2d_moments_gradients_match_jax(case):
    """dx and dw of a loss through all three outputs (the moment
    cotangents are folded into dy) against jax.grad, f32."""
    *_, stride, pad = CASES[case]
    jx, jw, px, pw = _inputs(case, jnp.float32, seed=1)
    rng = np.random.default_rng(2)
    cy = rng.normal(size=jax_convbn.conv2d_moments(
        jx, jw, stride, pad)[0].shape).astype(np.float32)
    cs, cq = rng.normal(size=(2, CASES[case][3])).astype(np.float32) * 1e-2

    def jax_loss(x_, w_):
        y, s, q = jax_convbn.conv2d_moments(x_, w_, stride, pad)
        return jnp.vdot(y, cy) + jnp.vdot(s, cs) + jnp.vdot(q, cq)

    jdx, jdw = jax.grad(jax_loss, argnums=(0, 1))(jx, jw)
    px.requires_grad_(True)
    pw.requires_grad_(True)
    y, s, q = conv2d_moments(px, pw, stride, pad)
    ((y * nchw(cy)).sum() + (s * torch.from_numpy(cs)).sum()
     + (q * torch.from_numpy(cq)).sum()).backward()
    np.testing.assert_allclose(px.grad.numpy(), np.transpose(
        np.asarray(jdx), (0, 3, 1, 2)), **GRAD_TOL)
    np.testing.assert_allclose(pw.grad.numpy(), np.transpose(
        np.asarray(jdw), (3, 2, 0, 1)), **GRAD_TOL)


def test_unsupported_convs_raise():
    """supported() agrees with the JAX package's on the NCHW shape; the op
    refuses what it does not take."""
    for shape, k, s, p in (((4, 8, 7, 7), 4, 2, 1), ((4, 8, 8, 8), 3, 2, 1),
                           ((4, 8, 8, 8), 4, 2, 0), ((4, 8, 3, 3), 4, 1, 0),
                           ((4, 8, 8, 8), 4, 2, 1), ((4, 8, 5, 5), 4, 1, 0)):
        b, c, h, w = shape
        assert supported(shape, k, s, p) == jax_convbn.supported(
            (b, h, w, c), k, s, p)
    x = torch.zeros((2, 8, 7, 7))
    with pytest.raises(ValueError, match="unsupported conv"):
        conv2d_moments(x, torch.zeros((4, 8, 4, 4)), 2, 1)
    with pytest.raises(ValueError, match="unsupported conv"):
        conv2d_moments(torch.zeros((2, 8, 8, 8)),
                       torch.zeros((4, 8, 3, 3)), 2, 1)


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX package on its fused route (conv2d_moments + the BN from
    its sums) and its Pallas BN elsewhere; returns the list of
    conv2d_moments calls the route made."""
    calls = []
    real = jax_convbn.conv2d_moments

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(jax_dcgan, "_convbn_pallas", lambda: True)
    monkeypatch.setattr(jax_bn_pallas, "use_pallas_bn", lambda: True)
    monkeypatch.setattr(jax_convbn, "conv2d_moments", spy)
    return calls


def _ema(bn, momentum=0.1):
    """The running statistics after one commit of the moments a train-mode
    call left on `bn`."""
    m = bn.moments
    unbiased = m.var[0] * (m.n / (m.n - 1))
    return ((1 - momentum) * bn.running_mean + momentum * m.mean[0],
            (1 - momentum) * bn.running_var + momentum * unbiased)


def test_conv_stack_fused_route_matches_jax(jax_fused):
    """The encoder's ConvStack in train mode, f32: its output and each BN's
    committed statistics against conv_stack_apply on the fused route (3
    conv2d_moments calls), and against the port's unfused route."""
    jm, params, state = jax_celeba()
    x = np.random.default_rng(3).random((4, 64, 64, 3)).astype(np.float32)
    want, new_state = jax_dcgan.conv_stack_apply(
        params["image_enc"]["conv"], state["enc"]["image"], ENC_SPECS,
        jnp.asarray(x), train=True)
    assert jax_fused == [(4, 32, 32, 32), (4, 16, 16, 64), (4, 8, 8, 128)]
    assert PORT_ENC_SPECS == ENC_SPECS
    sd = port_celeba(params, state).image_encoder.features.state_dict()
    outs = {}
    for fused in (True, False):
        stack = ConvStack(3, PORT_ENC_SPECS, conv_moments=fused,
                          device="cpu")
        stack.load_state_dict(sd)
        stack.train()
        y = stack(nchw(x)).detach()
        outs[fused] = (y, [_ema(stack[i]) for i in (3, 6, 9)])
    np.testing.assert_allclose(outs[True][0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(outs[True][0], outs[False][0], rtol=1e-4,
                               atol=1e-5)
    for j, (mean, var) in enumerate(outs[True][1]):
        np.testing.assert_allclose(mean.numpy(), np.asarray(
            new_state[j + 1]["mean"]), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(var.numpy(), np.asarray(
            new_state[j + 1]["var"]), rtol=1e-4, atol=1e-6)
        for a, b in zip((mean, var), outs[False][1][j]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_conv_stack_eval_mode_never_fuses(monkeypatch):
    """Eval mode takes the unfused path whatever the flag, as in JAX
    (fused_moments = train and ...)."""
    stack = ConvStack(3, PORT_ENC_SPECS, conv_moments=True, device="cpu")
    for m in stack:
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(torch.Generator().manual_seed(0))
    calls = []
    monkeypatch.setattr("mvae_tpu_torch.nn.dcgan.conv2d_moments",
                        lambda *a: calls.append(a))
    stack.eval()
    y = stack(torch.zeros((2, 3, 64, 64)))
    assert y.shape == (2, 256, 5, 5) and calls == []


@pytest.fixture(scope="module")
def fused_step():
    """One train-mode ELBO in f32 on the fused route on both sides (the
    JAX package with its Pallas BN and conv2d_moments patched in), from
    the same weights, batch and noise."""
    mp = pytest.MonkeyPatch()
    calls = []
    real = jax_convbn.conv2d_moments
    mp.setattr(jax_dcgan, "_convbn_pallas", lambda: True)
    mp.setattr(jax_bn_pallas, "use_pallas_bn", lambda: True)
    mp.setattr(jax_convbn, "conv2d_moments",
               lambda *a: calls.append(a[0].shape) or real(*a))
    try:
        jm, params, state = jax_celeba(seed=4)
        batch = _uint8_data(B, 71)
        key = jax.random.key(17)
        want = _jax_elbo(jm, params, state, batch, key)
    finally:
        mp.undo()
    pm = port_celeba(params, state, conv_moments=True)
    got = _port_elbo(pm, batch, jax_noise(key, 3, B))
    return want, got, pm, params, calls


def test_train_step_fused_route_matches_jax(fused_step):
    """Loss and per-term values at rtol 1e-4, every gradient within 5e-5
    in relative norm (the BN-fed biases within 2e-5 of their rounding
    noise), as test_train_elbo_f32_matches_jax holds the unfused step; the
    JAX step's trace took the fused route for the three BN'd convs."""
    (w_total, w_terms, grads, state), (total, per_term), pm, _, calls = \
        fused_step
    assert len(calls) == 3
    np.testing.assert_allclose(float(total), w_total, rtol=1e-4)
    np.testing.assert_allclose(per_term.numpy(), w_terms, rtol=1e-4)
    _grads_close(_grads_sd(pm), _jax_grads_sd(grads, state, pm),
                 rtol=5e-5, noise_atol=2e-5)


def test_train_step_fused_route_commits_like_jax(fused_step):
    """All 22 running statistics after the step against JAX's new state;
    the encoder's three conv BNs were committed from the fused moments."""
    (_, _, _, new_state), _, pm, params, _ = fused_step
    want = state_dict_from_jax(
        "celeba", params, jax.tree_util.tree_map(np.asarray, new_state))
    sd = pm.state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 22
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def bf16_fused_readings():
    """One train-mode ELBO under bf16 compute: the JAX package on its
    fused route (its Pallas BN elsewhere), the port's fused route and the
    port's unfused route, from one set of weights, batch and noise."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_dcgan, "_convbn_pallas", lambda: True)
    mp.setattr(jax_bn_pallas, "use_pallas_bn", lambda: True)
    try:
        jm, params, state = jax_celeba(compute_dtype=jnp.bfloat16)
        batch = _uint8_data(B, 51)
        key = jax.random.key(13)
        want = _jax_elbo(jm, params, state, batch, key, jnp.bfloat16)
    finally:
        mp.undo()
    noise = jax_noise(key, 3, B)
    ports = {}
    for fused in (True, False):
        pm = port_celeba(params, state, compute_dtype=torch.bfloat16,
                         conv_moments=fused)
        _port_elbo(pm, batch, noise, torch.bfloat16)
        ports[fused] = pm.state_dict()
    return state_dict_from_jax("celeba", params, jax.tree_util.tree_map(
        np.asarray, want[3])), ports


# bf16 compute, the encoder's second and third conv BNs (the first reads
# the same input on both routes). rel_l1 of the running statistics after
# one step of the port's fused route against two references: the JAX
# package's fused route (the same rounding points: z rounded to bf16, then
# swish in bf16 steps) and the port's unfused route (the BN kernel's swish
# rounded once from f32, so the next conv reads another input). Each limit
# lies between the two readings. The readings on weight seeds 0, 1, 2:
#   reading                    vs JAX fused              vs port unfused
#   features.6.running_mean    2.1e-6  2.8e-7  4.4e-8    7.5e-5 8.2e-5 7.3e-5
#   features.6.running_var     2.6e-7  6.7e-8  4.0e-8    1.0e-5 1.0e-5 1.0e-5
#   features.9.running_mean    2.1e-5  5.9e-6  1.3e-7    1.6e-4 1.6e-4 1.8e-4
#   features.9.running_var     4.3e-6  9.2e-7  5.6e-8    3.0e-5 3.6e-5 3.3e-5
BF16_FUSED_LIMITS = {
    "image_encoder.features.6.running_mean": 1e-5,
    "image_encoder.features.6.running_var": 2e-6,
    "image_encoder.features.9.running_mean": 6e-5,
    "image_encoder.features.9.running_var": 1.2e-5,
}


@pytest.mark.parametrize("reading", sorted(BF16_FUSED_LIMITS))
def test_bf16_fused_route_rounds_like_jax(bf16_fused_readings, reading):
    """The port's fused route in bf16 rounds where the JAX package's fused
    route does: closer to it than the limit, farther from the unfused
    route."""
    want, ports = bf16_fused_readings
    got = ports[True][reading].numpy()
    to_jax = rel_l1(got, want[reading])
    to_unfused = rel_l1(got, ports[False][reading].numpy())
    limit = BF16_FUSED_LIMITS[reading]
    assert to_jax < limit < to_unfused, (reading, to_jax, limit, to_unfused)


# bf16 gradients of the image encoder's conv weights, each in relative
# norm to the f32 step's: the fused route within this factor of the
# unfused route's gap. With y's cotangent rounded to bf16 before the fold
# (JAX's rounding point) the first two convs' weights read 1.45 to 1.67
# times the unfused gap at B=32 (weight seeds 0, 1); with the fold in f32,
# 1.05 to 1.17
FUSED_GRAD_FACTOR = 1.3


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_fused_route_gradients_as_close_as_unfused(seed):
    """One bf16 train step of CelebaMVAE(8) at B=32 on each route against
    the f32 step from the same weights: the fused route's encoder conv
    gradients lie as close to f32 as the unfused route's (the fold of
    ops/convbn.py rounds once), and within 5e-2 of the unfused route's."""
    b = 32
    _, params, state = jax_celeba(compute_dtype=jnp.bfloat16, seed=seed)
    batch = _uint8_data(b, 51 + seed)
    noise = jax_noise(jax.random.key(13 + seed), 3, b)
    grads = {}
    for name, dtype, fused in (("f32", torch.float32, False),
                               ("unfused", torch.bfloat16, False),
                               ("fused", torch.bfloat16, True)):
        pm = port_celeba(params, state, conv_moments=fused, compute_dtype=(
            None if dtype == torch.float32 else dtype))
        _port_elbo(pm, batch, noise, dtype)
        grads[name] = _grads_sd(pm)

    def gap(a, b_, k):
        want = grads[b_][k].astype(np.float64)
        return float(np.linalg.norm(grads[a][k] - want)
                     / np.linalg.norm(want))

    convs = [k for k, g in grads["f32"].items()
             if k.startswith("image_encoder.features") and g.ndim == 4]
    assert len(convs) == 4
    for k in convs:
        assert gap("fused", "f32", k) < FUSED_GRAD_FACTOR * gap(
            "unfused", "f32", k), k
    for k in grads["f32"]:
        if k not in BN_FED_BIASES:
            assert gap("fused", "unfused", k) < 5e-2, k
