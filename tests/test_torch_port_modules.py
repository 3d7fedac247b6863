"""The port's CelebA modules against the JAX package's, f32, eval mode.

Weights are the JAX model's own, carried across with
utils.weights.state_dict_from_jax; the BN affine parameters and running
statistics are randomized first so eval-mode BN does real work. The other
test_torch_port_* files build their models with the helpers here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.models.celeba import (
    CelebaMVAE as JaxCelebaMVAE, DEC_SPECS, ENC_SPECS, _mlp_bn_apply)
from mvae_tpu.nn.dcgan import conv_stack_apply, deconv_stack_apply, head_apply
from mvae_tpu.train.loop import decode_batch as jax_decode_batch

from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.train.loop import decode_batch, resolve_decode_dtype
from mvae_tpu_torch.utils.weights import state_dict_from_jax

L = 8
# f32 conv nets on the same weights: the sums run in another order (NCHW
# vs NHWC, oneDNN vs XLA); the golden-test tolerance of the JAX package
TOL = dict(rtol=1e-4, atol=1e-5)


def _randomize_bn(tree, rng):
    """Non-trivial BN affine parameters and running statistics."""
    if isinstance(tree, dict):
        if set(tree) == {"mean", "var"}:
            c = tree["mean"].shape[0]
            return {"mean": rng.normal(0, 0.3, c).astype(np.float32),
                    "var": (0.5 + rng.random(c)).astype(np.float32)}
        if set(tree) == {"scale", "bias"}:
            c = tree["scale"].shape[0]
            return {"scale": (0.5 + rng.random(c)).astype(np.float32),
                    "bias": rng.normal(0, 0.1, c).astype(np.float32)}
        return {k: _randomize_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize_bn(v, rng) for v in tree]
    return tree


def jax_celeba(n_latents=L, compute_dtype=None, seed=0):
    """A JAX CelebaMVAE with numpy params/state, BN randomized."""
    model = JaxCelebaMVAE(n_latents, compute_dtype=compute_dtype)
    params, state = model.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = _randomize_bn(jax.tree_util.tree_map(np.asarray, params), rng)
    state = _randomize_bn(jax.tree_util.tree_map(np.asarray, state), rng)
    return model, params, state


def port_celeba(params, state, n_latents=L, compute_dtype=None,
                conv_moments=False):
    """The port's CelebaMVAE on the CPU holding the JAX weights. In train
    mode it takes the JAX package's default route unless `conv_moments`:
    the fused conv + BN-moments route is opt-in there, and the tests of it
    (test_torch_port_convbn.py) patch the JAX side onto it."""
    model = CelebaMVAE(n_latents, compute_dtype, conv_moments=conv_moments,
                       device="cpu")
    sd = {k: torch.tensor(v)
          for k, v in state_dict_from_jax("celeba", params, state).items()}
    model.load_state_dict(sd, strict=True)
    return model


def celeba_batch(b, seed, uint8=False):
    rng = np.random.default_rng(seed)
    if uint8:
        image = rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
    else:
        image = rng.random((b, 64, 64, 3)).astype(np.float32)
    attrs = (rng.random((b, 18)) < 0.3).astype(np.float32)
    return {"image": image, "attrs": attrs}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


@pytest.fixture(scope="module")
def models():
    jm, params, state = jax_celeba()
    return jm, params, state, port_celeba(params, state)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_encoder_conv_stack(models):
    jm, params, state, pm = models
    x = celeba_batch(3, 1)["image"]
    want, _ = conv_stack_apply(params["image_enc"]["conv"],
                               state["enc"]["image"], ENC_SPECS,
                               jnp.asarray(x), train=False)
    got = pm.image_encoder.features(nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == (3, 5, 5, 256)
    _close(got, want)


def test_posterior_head(models):
    jm, params, state, pm = models
    h = np.random.default_rng(2).normal(size=(3, 5, 5, 256)).astype(
        np.float32)
    want = head_apply(params["image_enc"]["head"],
                      jnp.asarray(h.reshape(3, -1)), rng=None, train=False)
    got = pm.image_encoder.classifier(nchw(h).reshape(3, -1))
    _close(got, want)


def test_decoder_deconv_stack(models):
    jm, params, state, pm = models
    h = np.random.default_rng(3).normal(size=(3, 5, 5, 256)).astype(
        np.float32)
    want, _ = deconv_stack_apply(params["image_dec"]["deconv"],
                                 state["dec"]["image"], DEC_SPECS,
                                 jnp.asarray(h), train=False)
    got = pm.image_decoder.hallucinate(nchw(h)).permute(0, 2, 3, 1)
    assert got.shape == (3, 64, 64, 3) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("side", ["enc", "dec"])
def test_attribute_mlps(models, side):
    jm, params, state, pm = models
    d_in = 18 if side == "enc" else L
    x = np.random.default_rng(4).normal(size=(3, d_in)).astype(np.float32)
    want, _ = _mlp_bn_apply(params[f"attrs_{side}"], state[side]["attrs"],
                            jnp.asarray(x), train=False)
    mod = pm.attrs_encoder if side == "enc" else pm.attrs_decoder
    _close(mod(torch.from_numpy(x)), want)


def test_encode_and_decode(models):
    jm, params, state, pm = models
    batch = celeba_batch(3, 5)
    mu, lv, _ = jm.encode(params, state,
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          None, False)
    p_mu, p_lv, moments = pm.encode(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert moments == {"image": [], "attrs": []}      # eval mode: none
    assert p_mu.shape == (2, 3, L)
    _close(p_mu, mu)
    _close(p_lv, lv)
    z = np.random.default_rng(6).normal(size=(3, L)).astype(np.float32)
    want, _ = jm.decode(params, state, jnp.asarray(z), None, False)
    got, moments = pm.decode(torch.from_numpy(z))
    assert moments == []
    for k in ("image", "attrs"):
        assert got[k].shape == want[k].shape
        _close(got[k], want[k])


@pytest.mark.parametrize("names", [("image",), ("attrs",),
                                   ("attrs", "image")])
def test_infer_subsets(models, names):
    """The PoE over exactly the given modalities (placeholders for the
    rest), through the op the kernel serves (T = 1)."""
    jm, params, state, pm = models
    batch = celeba_batch(3, 7)
    mu, lv = jm.infer(params, state, {k: jnp.asarray(batch[k])
                                      for k in names})
    p_mu, p_lv = pm.infer({k: torch.from_numpy(batch[k]) for k in names})
    assert p_mu.shape == (3, L)
    _close(p_mu, mu)
    _close(p_lv, lv)


def rel_l1(got, want):
    """mean |got - want| / mean |want|, in f64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


@pytest.fixture(scope="module")
def bf16_models():
    """One set of weights: the JAX model in bf16, the port in bf16 and f32."""
    jm, params, state = jax_celeba(compute_dtype=jnp.bfloat16)
    return (jm, params, state,
            port_celeba(params, state, compute_dtype=torch.bfloat16),
            port_celeba(params, state))


def _bf16_outputs(case, jm, params, state, pb, pf):
    """name -> (JAX bf16, port bf16, port f32) outputs of one module."""
    batch = celeba_batch(3, 20)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if case == "encode":
        mu, lv, _ = jm.encode(params, state, jb, None, False)
        (bm, bl, _), (fm, fl, _) = pb.encode(tb), pf.encode(tb)
        return {f"{k} {m}": (want[i], got_b[i], got_f[i])
                for i, k in enumerate(("image", "attrs"))
                for m, want, got_b, got_f in (("mu", mu, bm, fm),
                                              ("logvar", lv, bl, fl))}
    if case == "deconv":
        h = np.random.default_rng(30).normal(size=(3, 5, 5, 256)).astype(
            np.float32)
        want, _ = deconv_stack_apply(params["image_dec"]["deconv"],
                                     state["dec"]["image"], DEC_SPECS,
                                     jnp.asarray(h), train=False,
                                     dtype=jnp.bfloat16)
        return {"logits": (want,) + tuple(
            m.image_decoder.hallucinate(nchw(h)).permute(0, 2, 3, 1)
            for m in (pb, pf))}
    if case == "decode":
        z = np.random.default_rng(40).normal(size=(3, L)).astype(np.float32)
        want, _ = jm.decode(params, state, jnp.asarray(z), None, False)
        got_b, got_f = (m.decode(torch.from_numpy(z))[0] for m in (pb, pf))
        return {k: (want[k], got_b[k], got_f[k]) for k in ("image", "attrs")}
    names = case.split()[1].split(",")                 # "infer a,b"
    want = jm.infer(params, state, {k: jb[k] for k in names})
    got_b, got_f = (m.infer({k: tb[k] for k in names}) for m in (pb, pf))
    return {m: (want[i], got_b[i], got_f[i])
            for i, m in enumerate(("mu", "logvar"))}


# bf16 compute. rel_l1 of the port in bf16 against two references on one
# set of weights: the JAX package in bf16 (a few bf16 rounding flips where
# oneDNN and XLA sum in another order, propagated) and the port in f32
# (every cast point's rounding). Each limit lies between the two readings,
# so a cast point out of place, or a bf16 model that computes in f32,
# fails. Readings on this test's inputs (CPU), and in brackets the largest
# JAX gap and the smallest f32 gap over weight seeds 0-4:
#   output               vs JAX   vs f32   limit  [JAX max, f32 min]
BF16_LIMITS = {
    ("encode", "image mu"): 2e-3,       # 6.3e-4   4.7e-3  [6.3e-4, 3.5e-3]
    ("encode", "image logvar"): 1.5e-3,  # 5.5e-4  9.8e-3  [5.5e-4, 3.8e-3]
    ("deconv", "logits"): 5e-4,         # 3.4e-6   4.2e-3  [2.9e-5, 3.9e-3]
    ("decode", "image"): 5e-4,          # 2.3e-6   4.1e-3  [6.3e-5, 3.8e-3]
    ("infer image", "mu"): 2e-3,        # 6.3e-4   4.8e-3  [6.3e-4, 3.5e-3]
    ("infer image", "logvar"): 3.5e-5,  # 9.1e-6   1.6e-4  [1.4e-5, 9.9e-5]
    ("infer attrs,image", "mu"): 5e-4,  # 2.2e-4   1.7e-3  [2.2e-4, 1.4e-3]
    ("infer attrs,image", "logvar"): 1.5e-5,  # 3.9e-6 6.8e-5 [5.9e-6, 4.3e-5]
}


@pytest.mark.parametrize("case", ["encode", "deconv", "decode",
                                  "infer image", "infer attrs",
                                  "infer attrs,image"])
def test_bf16_modules_match_jax(bf16_models, case):
    """Outputs with a limit in BF16_LIMITS pass through bf16 cast points:
    closer to JAX in bf16 than the limit, farther from the port in f32.
    The rest are f32 throughout (attribute MLPs, posterior logvar from the
    attribute expert alone): equal to the port in f32 bit for bit, and to
    JAX at the f32 tolerance."""
    jm, params, state, pb, pf = bf16_models
    with torch.no_grad():
        outs = _bf16_outputs(case, jm, params, state, pb, pf)
    for name, (want, got_b, got_f) in outs.items():
        assert got_b.dtype == torch.float32, name
        got_b, got_f = got_b.numpy(), got_f.numpy()
        limit = BF16_LIMITS.get((case, name))
        if limit is None:
            np.testing.assert_array_equal(got_b, got_f, err_msg=name)
            np.testing.assert_allclose(got_b, np.asarray(want), **TOL,
                                       err_msg=name)
            continue
        to_jax, to_f32 = rel_l1(got_b, want), rel_l1(got_b, got_f)
        assert to_jax < limit < to_f32, (name, to_jax, limit, to_f32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_batch_rounds_like_jax(dtype):
    """uint8 -> dtype / 255 gives JAX's values for every byte, bf16 too
    (one rounding of the quotient); f32 inputs pass through."""
    v = np.arange(256, dtype=np.uint8).reshape(1, 256)
    attrs = np.ones((1, 18), np.float32)
    want = jax_decode_batch({"image": jnp.asarray(v),
                             "attrs": jnp.asarray(attrs)},
                            getattr(jnp, dtype))
    got = decode_batch({"image": torch.from_numpy(v),
                        "attrs": torch.from_numpy(attrs)},
                       getattr(torch, dtype))
    assert got["image"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        got["image"].float().numpy(),
        np.asarray(want["image"]).astype(np.float32))
    assert got["attrs"].dtype == torch.float32


def test_resolve_decode_dtype():
    class M:
        compute_dtype = torch.bfloat16
    assert resolve_decode_dtype(M()) == torch.bfloat16
    assert resolve_decode_dtype(M(), torch.float32) == torch.float32
    M.compute_dtype = None
    assert resolve_decode_dtype(M()) == torch.float32
