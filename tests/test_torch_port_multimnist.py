"""The port's MultiMNIST family against the JAX package on the CPU: the GRU
primitives, the reference keys and the weight carry-across, encode and
decode (the text decoder's fed-back tokens token by token), the losses
(the CE over 4 positions with shared rows), the eval ELBO, one train-mode
ELBO with JAX's own eps and dropout masks (loss, gradients, the EMA
commit), bf16 between its two readings, the train step's noise stream,
the Sampler's softmax over the last axis, the numpy generator and the
shards both ways, and the CLIs on `--device cpu` over a tiny set, whose
checkpoint the JAX package's importer reads.

Same weights (`state_dict_from_jax`, BN randomized) and same numpy inputs
on both sides, at B <= 6 and n_latents 8 with the family's real widths.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.core.engine import multi_term_elbo as jax_multi_term_elbo
from mvae_tpu.data import multimnist as jax_mm
from mvae_tpu.data import native as jax_native
from mvae_tpu.data import text as jax_text
from mvae_tpu.data.mnist import load_mnist as jax_load_mnist
from mvae_tpu.models.multimnist import MultiMnistMVAE as JaxMultiMnist
from mvae_tpu.nn import rnn as jax_rnn
from mvae_tpu.serve import Sampler as JaxSampler
from mvae_tpu.train.driver import load_model_checkpoint as jax_load_model
from mvae_tpu.train.loop import decode_batch as jax_decode_batch
from mvae_tpu.train.loop import make_eval_step as jax_make_eval_step
from mvae_tpu.utils.torch_export import export_state_dict
from mvae_tpu.utils.torch_import import import_checkpoint

import mvae_tpu_torch.experiments.multimnist.datasets as mm_datasets
import mvae_tpu_torch.experiments.multimnist.loglike as mm_loglike
import mvae_tpu_torch.experiments.multimnist.sample as mm_sample
import mvae_tpu_torch.experiments.multimnist.train as mm_train
from mvae_tpu_torch.core.engine import multi_term_elbo
from mvae_tpu_torch.data import multimnist as port_mm
from mvae_tpu_torch.data import text as port_text
from mvae_tpu_torch.models import CelebaMVAE, MultiMnistMVAE
from mvae_tpu_torch.nn import rnn
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.checkpoint import BEST, CKPT
from mvae_tpu_torch.train.driver import load_model_checkpoint
from mvae_tpu_torch.train.loop import decode_batch, draw_noise, make_eval_step
from mvae_tpu_torch.utils.weights import checkpoint_family, state_dict_from_jax

from mvae_tpu_torch.data import native as port_native
from tests._torch_native import (
    build_jax_library, jax_library_reason, use_jax_library)
from tests.test_torch_import import _build_multimnist
from tests.test_torch_port_modules import TOL, _randomize_bn, rel_l1

L, B = 8, 4
H = 200
MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3        # the CLI's training weights
EVAL_LAMBDAS = [[1.0, 1.0]] * 3    # ... and its eval weights


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The port's side on one intra-op thread, restored after (see
    tests/test_torch_port_families.py: small ops under pytest-xdist, and
    the process's first CPU exp)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_model(compute_dtype=None, seed=0):
    jm = JaxMultiMnist(L, compute_dtype=compute_dtype)
    params, state = jm.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = _randomize_bn(jax.tree_util.tree_map(np.asarray, params), rng)
    state = _randomize_bn(jax.tree_util.tree_map(np.asarray, state), rng)
    return jm, params, state


def port_model(params, state, compute_dtype=None):
    model = MultiMnistMVAE(L, compute_dtype, device="cpu")
    sd = state_dict_from_jax("multimnist", params, state)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                          strict=True)
    return model


def mm_batch(b, seed, uint8=False):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (b, 50, 50, 1), dtype=np.uint8)
    return {"image": image if uint8 else (image / 255.0).astype(np.float32),
            "text": rng.integers(0, 12, (b, 4)).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def f32():
    jm, params, state = jax_model()
    return jm, params, state, port_model(params, state)


# --------------------------------------------------------------------------
# the GRU
# --------------------------------------------------------------------------

def _gru_params(rng, d_in, h):
    p = {"w_ih": rng.normal(0, 0.4, (d_in, 3 * h)),
         "w_hh": rng.normal(0, 0.4, (h, 3 * h)),
         "b_ih": rng.normal(0, 0.2, 3 * h), "b_hh": rng.normal(0, 0.2, 3 * h)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    torch_p = (torch.from_numpy(p["w_ih"].T.copy()),
               torch.from_numpy(p["w_hh"].T.copy()),
               torch.from_numpy(p["b_ih"]), torch.from_numpy(p["b_hh"]))
    return {k: jnp.asarray(v) for k, v in p.items()}, torch_p


def test_gru_cell_layer_and_bigru_last_step_match_jax():
    """gru_cell, gru_layer over 5 steps and bigru_last_step (the backward
    direction's first step on xs[-1]) against the JAX package's, f32 at
    rtol 1e-5."""
    rng = np.random.default_rng(0)
    d_in, h, t, b = 7, 6, 5, 3
    jf, pf = _gru_params(rng, d_in, h)
    jb, pb = _gru_params(rng, d_in, h)
    xs = rng.normal(size=(t, b, d_in)).astype(np.float32)
    h0 = rng.normal(size=(b, h)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-6)
    want = jax_rnn.gru_cell(jf, jnp.asarray(xs[0]), jnp.asarray(h0))
    got = rnn.gru_cell(pf, torch.from_numpy(xs[0]), torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    ys, ht = jax_rnn.gru_layer(jf, jnp.asarray(xs), jnp.asarray(h0))
    p_ys, p_ht = rnn.gru_layer(pf, torch.from_numpy(xs), torch.from_numpy(h0))
    np.testing.assert_allclose(p_ys.numpy(), np.asarray(ys), **tol)
    np.testing.assert_allclose(p_ht.numpy(), np.asarray(ht), **tol)
    for got, want in zip(rnn.bigru_last_step(pf, pb, torch.from_numpy(xs)),
                         jax_rnn.bigru_last_step(jf, jb, jnp.asarray(xs))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_gru_module_holds_torch_gru_keys():
    """GRU's parameters are nn.GRU's, key for key and shape for shape, and
    cell() picks one direction's tensors in gru_cell's order."""
    ref = torch.nn.GRU(5, 4, 2, bidirectional=True).state_dict()
    mine = rnn.GRU(5, 4, 2, bidirectional=True, device="cpu")
    assert {k: v.shape for k, v in mine.state_dict().items()} == {
        k: v.shape for k, v in ref.items()}
    assert mine.cell(1, True)[1] is mine.weight_hh_l1_reverse


# --------------------------------------------------------------------------
# weights, modules, losses, the eval ELBO (f32)
# --------------------------------------------------------------------------

def test_state_dict_keys_are_the_reference_keys(f32):
    ref = _build_multimnist(L, 12, H).state_dict()
    sd = f32[3].state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert sd[k].shape == v.shape, k


def test_state_dict_from_jax_is_the_exporter_bit_for_bit(f32):
    _, params, state, _ = f32
    want = export_state_dict("multimnist", params, state)
    got = state_dict_from_jax("multimnist", params, state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert checkpoint_family(got, {}) == "multimnist"


def test_encode_matches_jax(f32):
    """Both posteriors: the conv stack and head, the embedding, the bi-GRU's
    summed directions and h2p (f32, rtol 1e-4)."""
    jm, params, state, pm = f32
    batch = mm_batch(B, 1)
    mu, lv, _ = jm.encode(params, state, _jax(batch), None, False)
    with torch.no_grad():
        p_mu, p_lv, moments = pm.encode(_torch(batch))
    assert p_mu.shape == (2, B, L) and moments == {"image": [], "text": []}
    np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), **TOL)


def _tokens(logits):
    """The fed-back tokens: argmax of each step's log-softmax."""
    lo = jnp.asarray(np.asarray(logits, np.float32))
    return np.asarray(jnp.argmax(jax.nn.log_softmax(lo, axis=-1), axis=-1))


def _same_tokens(got, want):
    """The fed-back tokens equal JAX's token by token; a flip is reported
    as one, with where it happened."""
    flips = np.argwhere(got != want)
    assert flips.size == 0, f"fed-back token flips at (row, step) {flips}"


def test_decode_matches_jax_and_feeds_back_the_same_tokens(f32):
    """Image and text logits at rtol 1e-4, and the argmax tokens the text
    decoder fed back at each of its 4 steps equal to JAX's."""
    jm, params, state, pm = f32
    z = np.random.default_rng(2).normal(size=(6, L)).astype(np.float32)
    want, _ = jm.decode(params, state, jnp.asarray(z), None, False)
    with torch.no_grad():
        got, moments = pm.decode(torch.from_numpy(z))
    assert moments == []
    for k, shape in (("image", (6, 50, 50, 1)), ("text", (6, 4, 12))):
        assert got[k].dtype == torch.float32 and got[k].shape == shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)
    _same_tokens(_tokens(got["text"].numpy()), _tokens(want["text"]))


def test_recon_losses_match_jax(f32):
    """The image BCE over 2500 pixels and the CE summed over 4 positions,
    on 3 * B logit rows against B shared target rows (row r reads target
    r mod B), against JAX's on the repeated targets."""
    jm, _, _, pm = f32
    batch = mm_batch(B, 3)
    rng = np.random.default_rng(4)
    logits = {"image": 3 * rng.normal(size=(3 * B, 50, 50, 1)),
              "text": 3 * rng.normal(size=(3 * B, 4, 12))}
    for name, lo in logits.items():
        lo = lo.astype(np.float32)
        want = jm.recon_loss(name, jnp.asarray(lo),
                             jnp.asarray(np.concatenate([batch[name]] * 3)))
        got = pm.recon_loss(name, torch.from_numpy(lo),
                            torch.from_numpy(batch[name]))
        assert got.shape == (3 * B,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=name)


def test_eval_elbo_matches_jax(f32):
    jm, params, state, pm = f32
    batch = mm_batch(B, 6)
    total, per_term = jax_make_eval_step(jm, MASKS, EVAL_LAMBDAS)(
        params, state, _jax(batch))
    got, got_terms = make_eval_step(pm, MASKS, EVAL_LAMBDAS, device="cpu")(
        _torch(batch))
    np.testing.assert_allclose(got_terms.numpy(), np.asarray(per_term),
                               rtol=1e-4)
    np.testing.assert_allclose(float(got), float(total), rtol=1e-4)


# --------------------------------------------------------------------------
# the train-mode ELBO with JAX's noise
# --------------------------------------------------------------------------

def jax_noise(key, t, b):
    """The noise JAX's multi_term_elbo draws from `key` (engine.py:215-246):
    the image head's keep-mask (rngs[0]), eps (rngs[1]), and the text
    decoder's keep-mask of term t at step s from fold_in(split(rngs[2],
    T)[t], s) (models/multimnist.py:131-133), laid out as the port takes
    them: (4, T * B, H), the rows term-major."""
    rngs = jax.random.split(key, 3)
    keep = jax.random.bernoulli(rngs[0], 0.9, (b, 512))
    eps = jax.random.normal(rngs[1], (t, b, L), jnp.float32)
    dec_keys = jax.random.split(rngs[2], t)
    dec = np.stack([np.concatenate([np.asarray(jax.random.bernoulli(
        jax.random.fold_in(dec_keys[i], s), 0.9, (b, H)))
        for i in range(t)]) for s in range(4)])
    return np.asarray(eps), np.asarray(keep), dec


def _grads_sd(grads, state, pm):
    sd = state_dict_from_jax(
        "multimnist", jax.tree_util.tree_map(np.asarray, grads), state)
    return {k: sd[k] for k, _ in pm.named_parameters()}


# The Linear bias that feeds the decoder's first BN (image_decoder.upsample
# has none; the convs have no bias): MultiMNIST has no BN-fed bias, so
# every gradient is held in relative norm.
@pytest.fixture(scope="module")
def f32_step():
    """One train-mode ELBO in f32 on both sides, from the same weights,
    batch and JAX noise; returns (JAX's total, per_term, grads, new_state),
    the port's (total, per_term, model), and the JAX params."""
    jm, params, state = jax_model(seed=1)
    batch_u8 = mm_batch(B, 31, uint8=True)
    key = jax.random.key(7)
    batch = jax_decode_batch(_jax(batch_u8), jnp.float32)

    def loss(p):
        total, aux, new_state = jax_multi_term_elbo(
            jm, p, state, batch, jnp.asarray(MASKS), jnp.asarray(LAMBDAS),
            key, 0.7, train=True)
        return total, (aux["per_term"], new_state)

    (total, (per_term, new_state)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    pm = port_model(params, state)
    pm.train()
    p_total, aux = multi_term_elbo(
        pm, decode_batch(_torch(batch_u8)), torch.tensor(MASKS),
        torch.tensor(LAMBDAS), 0.7, train=True,
        noise=tuple(torch.tensor(a) for a in jax_noise(key, 3, B)))
    p_total.backward()
    return ((float(total), np.asarray(per_term), grads, new_state),
            (p_total.detach(), aux["per_term"].detach(), pm), params, state)


def test_train_elbo_matches_jax(f32_step):
    """Total and per-term at rtol 1e-4; every gradient within 5e-5 of
    JAX's in relative Frobenius norm (the largest read 3.1e-6, the first
    conv's)."""
    (w_total, w_terms, grads, _), (total, per_term, pm), _, state = f32_step
    np.testing.assert_allclose(float(total), w_total, rtol=1e-4)
    np.testing.assert_allclose(per_term.numpy(), w_terms, rtol=1e-4)
    want = _grads_sd(grads, state, pm)
    for k, p in pm.named_parameters():
        # the backward GRU's weight_hh meets h0 = 0 only: both exactly 0
        gap = np.linalg.norm(p.grad.numpy() - want[k])
        assert gap <= 5e-5 * np.linalg.norm(want[k]), (k, gap)


def test_commit_ema_states_matches_jax(f32_step):
    """The image encoder's and decoder's running statistics after the
    step against JAX's new_state (decoder committed T = 3 times, encoder
    k = 2 times)."""
    (_, _, _, new_state), (_, _, pm), params, _ = f32_step
    want = state_dict_from_jax(
        "multimnist", params, jax.tree_util.tree_map(np.asarray, new_state))
    sd = pm.state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 12
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_train_text_decoder_tokens_match_jax():
    """In train mode, with JAX's per-step dropout masks, the text decoder's
    logits at rtol 1e-4 and its fed-back tokens equal to JAX's."""
    jm, params, state = jax_model(seed=2)
    z = np.random.default_rng(5).normal(size=(6, L)).astype(np.float32)
    key = jax.random.key(11)
    want = jm._decode_text(params["text_dec"], jnp.asarray(z), key, True)
    masks = np.stack([np.asarray(jax.random.bernoulli(
        jax.random.fold_in(key, s), 0.9, (6, H))) for s in range(4)])
    pm = port_model(params, state)
    pm.train()
    with torch.no_grad():
        got = pm.text_decoder(torch.from_numpy(z), torch.from_numpy(masks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _same_tokens(_tokens(got.numpy()), _tokens(want))
    with pytest.raises(ValueError, match="keep-masks"):
        pm.text_decoder(torch.from_numpy(z))


def test_draw_noise_draws_the_decoder_masks_last():
    """MultiMNIST's noise: eps, the head's keep-mask, then the text
    decoder's (4, T * B, H) keep-masks at rate 0.1, from one generator;
    CelebA's stream (no decoder dropout) is the same two draws and no
    third."""
    mm = MultiMnistMVAE(L, device="cpu")
    gen, twin = (torch.Generator().manual_seed(3) for _ in range(2))
    eps, keep, dec = draw_noise(mm, 3, 100, gen)
    assert eps.shape == (3, 100, L) and keep.shape == (100, 512)
    assert dec.shape == (4, 300, H) and dec.dtype == torch.bool
    assert abs(dec.float().mean().item() - 0.9) < 0.01
    ce = CelebaMVAE(L, device="cpu")
    c_eps, c_keep = draw_noise(ce, 3, 100, twin)
    assert torch.equal(c_eps, eps) and torch.equal(c_keep, keep)
    assert torch.equal(dec, torch.rand((4, 300, H), generator=twin) < 0.9)
    mm.train()
    batch = decode_batch(_torch(mm_batch(2, 8, uint8=True)))
    with pytest.raises(ValueError, match="decode_keep_mask"):
        multi_term_elbo(mm, batch, torch.tensor(MASKS), torch.tensor(LAMBDAS),
                        1.0, train=True, noise=(eps[:, :2], keep[:2]))


# --------------------------------------------------------------------------
# bf16
# --------------------------------------------------------------------------

# Outputs that pass through a bf16 rounding (the conv stacks and the image
# head): each lies closer to JAX in bf16 than BF16_MARGIN times its gap to
# the port in f32 (rel_l1). The text side stays f32 and equals the port's
# f32 bit for bit. The eval loss is held to JAX's bf16 loss at the f32
# tolerance.
BF16_OUTPUTS = ("image mu", "image logvar", "image logits")
BF16_MARGIN = 0.1


def test_bf16_between_its_readings(f32):
    jm_f, params, state, pf = f32
    jm = JaxMultiMnist(L, compute_dtype=jnp.bfloat16)
    pb = port_model(params, state, torch.bfloat16)
    batch = mm_batch(B, 11)
    z = np.random.default_rng(10).normal(size=(B, L)).astype(np.float32)
    mu, lv, _ = jm.encode(params, state, _jax(batch), None, False)
    rec, _ = jm.decode(params, state, jnp.asarray(z), None, False)
    _, terms = jax_make_eval_step(jm, MASKS, EVAL_LAMBDAS)(
        params, state, _jax(batch))
    want = {"image mu": mu[0], "image logvar": lv[0], "text mu": mu[1],
            "text logvar": lv[1], "image logits": rec["image"],
            "text logits": rec["text"], "eval per_term": terms}
    outs = []
    for m in (pb, pf):
        with torch.no_grad():
            p_mu, p_lv, _ = m.encode(_torch(batch))
            p_rec, _ = m.decode(torch.from_numpy(z))
        _, p_terms = make_eval_step(m, MASKS, EVAL_LAMBDAS, device="cpu")(
            _torch(batch))
        outs.append(dict(zip(want, (p_mu[0], p_lv[0], p_mu[1], p_lv[1],
                                    p_rec["image"], p_rec["text"],
                                    p_terms))))
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        got_b, got_f = outs[0][name].numpy(), outs[1][name].numpy()
        if name == "eval per_term":
            np.testing.assert_allclose(got_b, w, rtol=1e-4)
        elif name in BF16_OUTPUTS:
            to_jax, to_f32 = rel_l1(got_b, w), rel_l1(got_b, got_f)
            assert to_jax < BF16_MARGIN * to_f32, (name, to_jax, to_f32)
        else:
            np.testing.assert_array_equal(got_b, got_f, err_msg=name)
            np.testing.assert_allclose(got_b, w, **TOL, err_msg=name)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_sampler_softmax_over_the_last_axis(f32):
    """reconstruct from the image: the text (N, 4, 12) is a softmax over
    the 12 characters of each position, the image a sigmoid, as the JAX
    Sampler activates them."""
    jm, params, state, pm = f32
    batch = mm_batch(3, 12)
    want = JaxSampler(jm, params, state).reconstruct(
        {"image": jnp.asarray(batch["image"])})
    got = Sampler(pm, device="cpu").reconstruct({"image": batch["image"]})
    for k in ("image", "text"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)
    assert got["text"].shape == (3, 4, 12)
    np.testing.assert_allclose(got["text"].sum(-1).numpy(), 1.0, rtol=1e-6)


# --------------------------------------------------------------------------
# data: the codec, the generator, the shards
# --------------------------------------------------------------------------

def test_text_codec_matches_jax():
    for s in ("", "7", "042", "9981"):
        np.testing.assert_array_equal(port_text.encode_string(s),
                                      jax_text.encode_string(s))
    tokens = np.array([10, 3, 11, 0])
    assert port_text.decode_tokens(tokens) == jax_text.decode_tokens(
        tokens) == "^30"
    assert (port_text.N_CHARACTERS, port_text.SOS, port_text.FILL) == (
        jax_text.N_CHARACTERS, jax_text.SOS, jax_text.FILL)


@pytest.mark.parametrize("opts", [
    {}, {"min_digits": 2, "max_digits": 3, "translate": False},
    {"fixed": True, "reverse": True, "no_repeat": True},
    {"fixed": True, "scramble": True, "resize": False}])
def test_generator_is_the_numpy_path_bit_for_bit(opts):
    """mk_dataset from one seed and one digit pool: images and strings
    equal to the JAX package's numpy generator, variant by variant."""
    images, labels = jax_load_mnist("unused", train=False, flatten=False,
                                    synthetic_ok=True).arrays.values()
    digits = images.reshape(-1, 28, 28)[:500] * 255.0
    labels = labels[:500]
    got = port_mm.mk_dataset(25, digits, labels, np.random.default_rng(5),
                             **opts)
    want = jax_mm.mk_dataset(25, digits, labels, np.random.default_rng(5),
                             **opts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def jax_native_so(tmp_path_factory):
    """The JAX package's native library, built read-only from its sources
    (never by make in its directory); None where it cannot build here."""
    return build_jax_library(tmp_path_factory.mktemp("jax_native"))


@pytest.mark.parametrize("use_native", [False, None])
def test_shards_load_both_ways(tmp_path, monkeypatch, jax_native_so,
                               use_native):
    """make_dataset writes the shards the JAX package's make_dataset writes
    with the same use_native, byte for byte in their arrays, and each side
    loads the other's: False is both numpy generators; None (the default)
    both native compositors where g++ builds them, both numpy where there
    is no g++."""
    core, jax_lib = port_native.unavailable_reason("core"), \
        jax_library_reason()
    if use_native is None and core is None and jax_lib is not None:
        pytest.skip(f"the port composites natively, the JAX package's "
                    f"library cannot build: {jax_lib}")
    use_jax_library(monkeypatch, jax_native_so)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_mm.make_dataset(str(port_dir), n_train=30, n_test=12,
                         use_native=use_native)
    jax_mm.make_dataset(str(jax_dir), n_train=30, n_test=12,
                        use_native=use_native)
    assert (jax_native._lib is not None) == (
        use_native is None and jax_native_so is not None)
    for train in (True, False):
        got = port_mm.load_multimnist(str(jax_dir), train=train)
        want = jax_mm.load_multimnist(str(port_dir), train=train)
        same = port_mm.load_multimnist(str(port_dir), train=train)
        for k in ("image", "text"):
            assert got.arrays[k].dtype == want.arrays[k].dtype
            np.testing.assert_array_equal(got.arrays[k], want.arrays[k])
            np.testing.assert_array_equal(same.arrays[k], want.arrays[k])
    assert got.arrays["image"].shape == (12, 50, 50, 1)


# --------------------------------------------------------------------------
# the CLIs on the CPU over a tiny set
# --------------------------------------------------------------------------

N_TRAIN, N_TEST, CLI_B = 40, 20, 10
CLI_FLAGS = ["--device", "cpu", "--n-latents", str(L), "--batch-size",
             str(CLI_B), "--log-interval", "2", "--annealing-epochs", "1",
             "--seed", "3", "--f32"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = main(argv)
    return value, buf.getvalue()


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The datasets CLI (N_TRAIN / N_TEST rows), then the train CLI (--f32)
    for one epoch and --resume for a second; (out dir, data dir,
    stdout)."""
    tmp = tmp_path_factory.mktemp("multimnist")
    data, out = str(tmp / "data"), str(tmp / "models")
    _, text0 = _run(mm_datasets.main, ["--data-dir", data, "--n-train",
                                       str(N_TRAIN), "--n-test", str(N_TEST)])
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.backends.cudnn, "allow_tf32",
               torch.backends.cudnn.allow_tf32)
    try:
        flags = CLI_FLAGS + ["--data-dir", data, "--out-dir", out]
        _, text = _run(mm_train.main, flags + ["--epochs", "1"])
        _, text2 = _run(mm_train.main, flags + [
            "--epochs", "2", "--resume", os.path.join(out, CKPT)])
    finally:
        mp.undo()
    return out, data, text0 + text + text2


def test_cli_trains_and_resumes(cli_run):
    out, _, text = cli_run
    assert "wrote multimnist shards" in text and "generating" not in text
    assert f"resumed from {os.path.join(out, CKPT)} at epoch 1" in text
    tests = [float(ln.split()[-1]) for ln in text.splitlines()
             if ln.startswith("====> Test Loss")]
    assert len(tests) == 2 and all(np.isfinite(tests))
    assert "Train Epoch: 2 [0/40" in text
    for name in (CKPT, BEST):
        ckpt = torch.load(os.path.join(out, name), map_location="cpu",
                          weights_only=True)
        assert ckpt["model"] == "multimnist" and ckpt["n_latents"] == L


def test_cli_samples_with_and_without_conditions(cli_run, tmp_path):
    """The sample CLI from the prior, a digit string, a test image of that
    string and both: a PNG grid and one decoded string a sample."""
    out, data, _ = cli_run
    text = port_text.decode_tokens(
        port_mm.load_multimnist(data, train=False).arrays["text"][0])
    for i, extra in enumerate(([], ["--condition-on-text", text],
                               ["--condition-on-image", text],
                               ["--condition-on-image", text,
                                "--condition-on-text", text])):
        d = tmp_path / str(i)
        res, _ = _run(mm_sample.main, [os.path.join(out, BEST), "--device",
                                       "cpu", "--n-samples", "10",
                                       "--data-dir", data, "--out-dir",
                                       str(d), *extra])
        assert (d / "sample_image.png").read_bytes()[:8] == \
            b"\x89PNG\r\n\x1a\n"
        lines = (d / "sample_text.txt").read_text().splitlines()
        assert len(lines) == 10 and lines[3].startswith("Text (3): ")
        assert res["image"].shape == (10, 50, 50, 1)
        np.testing.assert_allclose(res["text"].sum(-1).numpy(), 1.0,
                                   rtol=1e-6)


def test_cli_loglike_every_target(cli_run):
    out, data, _ = cli_run
    for target in ("image", "text", "joint"):
        ll, text = _run(mm_loglike.main, [
            os.path.join(out, BEST), "--device", "cpu", "--target", target,
            "--n-samples", "4", "--batch-size", "8", "--max-examples", "12",
            "--data-dir", data])
        assert np.isfinite(ll) and ll < 0
        assert f"====> log p({target}) >= {ll:.4f}  (K=4, N=16)" in text


def test_cli_checkpoint_loads_into_jax(cli_run, tmp_path):
    """model_best.pth.tar read by the JAX package's importer gives the
    port's eval posteriors (f32, the golden tolerance), and Sampler serves
    it."""
    out, _, _ = cli_run
    src = os.path.join(out, BEST)
    path, meta = import_checkpoint("multimnist", src, str(tmp_path))
    assert meta["n_latents"] == L
    jm, params, state, _ = jax_load_model(path, JaxMultiMnist)
    pm, _ = load_model_checkpoint(src, MultiMnistMVAE, device="cpu")
    batch = mm_batch(4, 14)
    for names in (("image",), ("text",), ("image", "text")):
        mu, lv = jm.infer(params, state, {k: jnp.asarray(batch[k])
                                          for k in names})
        with torch.no_grad():
            p_mu, p_lv = pm.infer({k: torch.from_numpy(batch[k])
                                   for k in names})
        np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), **TOL)
        np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), **TOL)
    sampler = Sampler.from_checkpoint(src, device="cpu")
    assert type(sampler.model) is MultiMnistMVAE
    assert sampler.sample(3, {"text": batch["text"][:1]})["text"].shape == (
        3, 4, 12)
