"""The port's vision family against the JAX package on the CPU: the image
transforms (gray, obscure, the alpha composite and the watermark at rtol
1e-6; the landmark masks and synthetic landmarks bit for bit; Canny in
both threshold modes, fixpoint and bounded hysteresis, equal but at
pixels where JAX's own numbers sit on a decision, CANNY_TIE_RTOL), the
whole derive_modalities, the reference keys and the carry-across bit for
bit, encode, decode and infer, the eval ELBO with and without
reconstruction masks, one train-mode ELBO at T = 7 with RECON_MASKS and
JAX's noise (loss, gradients, the EMA commit) on both encoder routes,
bf16 between its two readings, the IWAE's chunked decode, host streaming
(JAX's batch order and betas; the resident and streamed paths give one
loss on a set of multiples of 1/255), and the CLIs on `--device cpu` over
a tiny synthetic set, whose checkpoint the JAX package's importer reads.

Same weights (`state_dict_from_jax`, BN randomized) and the same numpy
inputs on both sides, at B <= 4 and n_latents 8 with the family's real
widths.
"""

import contextlib
import copy
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

import mvae_tpu.train.driver as jax_driver
import mvae_tpu.train.loop as jax_loop
from mvae_tpu.core.engine import multi_term_elbo as jax_multi_term_elbo
from mvae_tpu.core.loglike import iwae_log_marginal as jax_iwae
from mvae_tpu.data import vision as jax_vision
from mvae_tpu.image import transforms as JT
from mvae_tpu.models.vision import VisionMVAE as JaxVision
from mvae_tpu.train.driver import load_model_checkpoint as jax_load_model
from mvae_tpu.train.loop import decode_batch as jax_decode_batch
from mvae_tpu.train.loop import make_eval_step as jax_make_eval_step
from mvae_tpu.utils.cli import train_parser as jax_train_parser
from mvae_tpu.utils.torch_export import export_state_dict
from mvae_tpu.utils.torch_import import import_checkpoint

import mvae_tpu_torch.core.loglike as loglike
import mvae_tpu_torch.data.vision as vision_data
import mvae_tpu_torch.experiments.vision.loglike as v_loglike
import mvae_tpu_torch.experiments.vision.sample as v_sample
import mvae_tpu_torch.experiments.vision.setup as v_setup
import mvae_tpu_torch.experiments.vision.train as v_train
import mvae_tpu_torch.train.driver as driver
import mvae_tpu_torch.train.loop as loop
from mvae_tpu_torch.core.engine import multi_term_elbo
from mvae_tpu_torch.data.celeba import synthetic_celeba
from mvae_tpu_torch.data.pipeline import ArrayDataset
from mvae_tpu_torch.image import transforms as T
from mvae_tpu_torch.models import VisionMVAE
from mvae_tpu_torch.models.vision import CHANNELS, MODALITIES
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.checkpoint import BEST, CKPT
from mvae_tpu_torch.train.driver import load_model_checkpoint
from mvae_tpu_torch.train.loop import (
    decode_batch, make_eval_step, make_train_step)
from mvae_tpu_torch.utils.weights import checkpoint_family, state_dict_from_jax

from tests.test_torch_import import _dcgan_image_decoder, _dcgan_image_encoder
from tests.test_torch_port_driver import _OneDevice
from tests.test_torch_port_modules import TOL, _randomize_bn, rel_l1

L, B = 8, 2
TERM_MASKS, RECON_MASKS = v_train.TERM_MASKS, v_train.RECON_MASKS
TERM_LAMBDAS = v_train.TERM_LAMBDAS
EVAL_MASKS, EVAL_LAMBDAS = v_train.EVAL_MASKS, v_train.EVAL_LAMBDAS
# arithmetic transforms (a 3-term dot, a product, a composite): f32 apart
# only by the order or fusing of a few operations
ARITH_TOL = dict(rtol=1e-6, atol=1e-7)
# Canny: the blur and the Sobel through F.conv2d against XLA's convolution
# sum in another order (the magnitudes read up to 1.7e-6 apart where the
# largest is 4.2), so a pixel whose JAX magnitude (or NMS interpolant, or
# gradient octant) lies within this fraction of its image's largest
# magnitude from the comparison that decides it may flip, and hysteresis
# may carry the flip along its 8-connected weak edge. Every other pixel is
# held equal.
CANNY_TIE_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The port's side on one intra-op thread, restored after (see
    tests/test_torch_port_families.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def vision_batch(b, seed, uint8=False):
    """The six modalities of b rows: uniform pixels, or their uint8."""
    rng = np.random.default_rng(seed)
    out = {}
    for m in MODALITIES:
        v = rng.integers(0, 256, (b, 64, 64, CHANNELS[m]), dtype=np.uint8)
        out[m] = v if uint8 else (v.astype(np.float32) / np.float32(255))
    return out


# --------------------------------------------------------------------------
# the image transforms
# --------------------------------------------------------------------------

def _faces(n=3, seed=0):
    """Rendered synthetic faces (landmark drawings, RGB) and the synthetic
    CelebA set's blobs: n of each."""
    drawn = np.stack([np.repeat(T.landmark_mask(
        64, 64, vision_data.synthetic_landmarks(seed=seed + i)), 3, -1)
        for i in range(n)])
    return np.concatenate([drawn, synthetic_celeba(n, seed=seed)
                           .arrays["image"]]).astype(np.float32)


def _box():
    """A white box on black and a gray one on a ramp: straight edges whose
    magnitudes tie across the edge, the NMS's hardest case."""
    img = np.zeros((2, 64, 64, 3), np.float32)
    img[0, 16:40, 20:52] = 1.0
    img[1] = np.linspace(0.0, 0.3, 64, dtype=np.float32)[None, :, None]
    img[1, 10:30, 10:30] += 0.5
    return img


IMAGES = {"faces": _faces, "box": _box}


@pytest.mark.parametrize("name", ["gray", "obscure", "composite",
                                  "watermark"])
def test_arithmetic_transforms_match_jax(name):
    rng = np.random.default_rng(3)
    rgb = rng.random((4, 64, 64, 3)).astype(np.float32)
    wm = T.make_watermark(64, 64)
    if name == "watermark":
        np.testing.assert_array_equal(wm, JT.make_watermark(64, 64))
        np.testing.assert_array_equal(T.make_watermark(32, 48),
                                      JT.make_watermark(32, 48))
        np.testing.assert_array_equal(T.load_watermark(64, 64),
                                      JT.load_watermark(64, 64))
        return
    fns = {"gray": (T.rgb_to_grayscale, JT.rgb_to_grayscale, ()),
           "obscure": (T.obscure, JT.obscure, ()),
           "composite": (T.alpha_composite, JT.alpha_composite, (wm,))}
    mine, ref, extra = fns[name]
    got = mine(torch.from_numpy(rgb), *map(torch.from_numpy, extra))
    want = ref(jnp.asarray(rgb), *map(jnp.asarray, extra))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ARITH_TOL)


def test_load_watermark_reads_a_file(tmp_path):
    """<data_dir>/watermark.png, resized bicubic, equals the JAX
    package's reading of it."""
    rgba = np.random.default_rng(4).integers(0, 256, (40, 30, 4),
                                             dtype=np.uint8)
    from PIL import Image
    Image.fromarray(rgba, "RGBA").save(tmp_path / "watermark.png")
    got = T.load_watermark(64, 64, data_dir=str(tmp_path))
    np.testing.assert_array_equal(
        got, JT.load_watermark(64, 64, data_dir=str(tmp_path)))
    assert got.shape == (64, 64, 4) and got.dtype == np.float32


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_landmarks_and_masks_are_jax_bit_for_bit(seed):
    lms = vision_data.synthetic_landmarks(64, 64, seed=seed)
    np.testing.assert_array_equal(
        lms, jax_vision.synthetic_landmarks(64, 64, seed=seed))
    for h, w, pts in ((64, 64, lms), (48, 40, lms * 0.7), (64, 64, None)):
        np.testing.assert_array_equal(T.landmark_mask(h, w, pts),
                                      JT.landmark_mask(h, w, pts))
    np.testing.assert_array_equal(
        vision_data.synthetic_masks(12, 64, 64, seed),
        1.0 - np.stack([JT.landmark_mask(64, 64, None if r < 0.05 else lm)
                        for r, lm in _jax_mask_draws(12, seed)]))


def _jax_mask_draws(n, seed):
    """The draws of mvae_tpu/data/vision.py:96-105, as (u, landmarks)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        u = rng.random()
        yield u, (None if u < 0.05 else jax_vision.synthetic_landmarks(
            64, 64, seed=int(rng.integers(1 << 31))))


def _jax_canny_parts(rgb, mode, low=0.1, high=0.2):
    """JAX's magnitude, gradients, NMS survivors and thresholds
    (image/transforms.py:126-179) on rgb (B, H, W, 3)."""
    x = JT.rgb_to_grayscale(jnp.asarray(rgb))[..., 0]
    g = JT._sep_blur(x, 2.0) / JT._sep_blur(jnp.ones_like(x), 2.0)
    gx, gy = JT._conv3(g, JT._SOBEL_X), JT._conv3(g, JT._SOBEL_Y)
    mag = jnp.sqrt(gx * gx + gy * gy)
    keep = JT._interp_nms(mag, gy, gx)
    if mode == "absolute":
        lo, hi = np.float32(low), np.float32(high)
    else:
        peak = np.asarray(jnp.max(jnp.where(keep, mag, 0.0), axis=(1, 2),
                                  keepdims=True) + 1e-12)
        lo, hi = low * peak, high * peak
    return tuple(np.asarray(a) for a in (mag, gy, gx, keep)) + (lo, hi)


def _ties(mag, gy, gx, lo, hi):
    """Pixels where one of JAX's decisions is within CANNY_TIE_RTOL of the
    image's largest magnitude: a threshold, an NMS comparison (any octant
    case's interpolant), the octant itself (|gy| against |gx|, either
    against 0)."""
    r = CANNY_TIE_RTOL * mag.max(axis=(1, 2), keepdims=True)
    near = (np.abs(mag - hi) <= r) | (np.abs(mag - lo) <= r)
    ai, aj = np.abs(gy), np.abs(gx)
    near |= (np.abs(ai - aj) <= r) | (ai <= r) | (aj <= r)
    with np.errstate(divide="ignore", invalid="ignore"):
        w1 = np.where(ai > 0, aj / np.where(ai > 0, ai, 1), 0)
        w2 = np.where(aj > 0, ai / np.where(aj > 0, aj, 1), 0)

    def s(dy, dx):
        return np.roll(mag, (-dy, -dx), axis=(1, 2))

    for w, pairs in ((w1, ((s(-1, 0), s(-1, 1)), (s(1, 0), s(1, -1)),
                           (s(1, 0), s(1, 1)), (s(-1, 0), s(-1, -1)))),
                     (w2, ((s(0, 1), s(-1, 1)), (s(0, -1), s(1, -1)),
                           (s(0, 1), s(1, 1)), (s(0, -1), s(-1, -1))))):
        for c1, c2 in pairs:
            near |= np.abs(c2 * w + c1 * (1 - w) - mag) <= r
    return near


def _held_but_ties(got, want, ties, weak, what):
    """got equals want except in 8-connected components of `weak` (the
    pixels hysteresis may reach, either side's) that hold a tie pixel, and
    at tie pixels. Returns the count of pixels that differ."""
    diff = got != want
    if not diff.any():
        return 0
    ok = ties.copy()
    for i in range(len(got)):
        lab, _ = scipy.ndimage.label(weak[i], structure=np.ones((3, 3)))
        near = np.unique(lab[ties[i] & weak[i]])
        ok[i] |= np.isin(lab, near[near > 0])
    assert not (diff & ~ok).any(), (what, np.argwhere(diff & ~ok)[:5])
    return int(diff.sum())


@pytest.mark.parametrize("iters", [None, 2])
@pytest.mark.parametrize("mode", ["absolute", "relative"])
@pytest.mark.parametrize("image", sorted(IMAGES))
def test_canny_matches_jax_but_at_ties(image, mode, iters):
    """The port's magnitude within 1e-6 of JAX's (as a fraction of the
    image's largest); its NMS survivors and
    strong and weak pixels equal JAX's but at ties; its hysteresis on
    JAX's strong and weak pixels equals JAX's edges bit for bit; its edges
    equal JAX's but at ties and what hysteresis carries from them."""
    rgb = IMAGES[image]()
    mag, gy, gx, keep, lo, hi = _jax_canny_parts(rgb, mode)
    want = np.asarray(JT.canny_edges(jnp.asarray(rgb), hysteresis_iters=iters,
                                     threshold_mode=mode))[..., 0]
    x = torch.from_numpy(rgb)
    p_mag, p_gy, p_gx = (a.numpy() for a in T.canny_gradients(x))
    scale = mag.max(axis=(1, 2), keepdims=True)
    assert (np.abs(p_mag - mag) <= 1e-6 * scale).all(), np.abs(
        p_mag - mag).max()
    p_keep = T._interp_nms(*(torch.from_numpy(a) for a in (p_mag, p_gy,
                                                             p_gx))).numpy()
    ties = _ties(mag, gy, gx, lo, hi)
    _held_but_ties(p_keep, keep, ties, np.zeros_like(keep), "nms")
    strong, weak = keep & (mag >= hi), keep & (mag >= lo)
    edges, n = T.hysteresis(torch.from_numpy(strong), torch.from_numpy(weak),
                            iters)
    np.testing.assert_array_equal(edges.numpy(), want.astype(bool))
    assert n >= 1 and (iters is None or n == iters)
    got, n2 = T.canny_edges(x, hysteresis_iters=iters, threshold_mode=mode,
                            return_iters=True)
    assert got.shape == (len(rgb), 64, 64, 1) and got.dtype == torch.float32
    p_weak = p_keep & (p_mag >= (lo if mode == "absolute" else
                                 0.1 * (np.where(p_keep, p_mag, 0).max(
                                     axis=(1, 2), keepdims=True) + 1e-12)))
    flips = _held_but_ties(got.numpy()[..., 0], want, ties, weak | p_weak,
                           "edges")
    print(f"canny {image} {mode} iters={iters}: {flips} of {want.size} "
          f"pixels differ (ties {int(ties.sum())}), {n2} iterations")


def test_derive_modalities_matches_jax():
    """The six modalities of the same rows and seed: gray, obscured and
    watermark at rtol 1e-6, the image and the synthetic masks bit for bit,
    the edges (absolute thresholds) but at ties; precomputed masks pass
    through."""
    rgb = _faces(2, seed=5)
    want = jax_vision.derive_modalities(rgb, seed=9)
    stats = {}
    got = vision_data.derive_modalities(rgb, seed=9, device="cpu",
                                        stats=stats)
    assert sorted(got) == sorted(want) == sorted(MODALITIES)
    for k in ("gray", "obscured", "watermark"):
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], **ARITH_TOL, err_msg=k)
    for k in ("image", "mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mag, gy, gx, keep, lo, hi = _jax_canny_parts(rgb, "absolute")
    _held_but_ties(got["edge"][..., 0], want["edge"][..., 0],
                   _ties(mag, gy, gx, lo, hi), keep & (mag >= lo), "edge")
    assert len(stats["hysteresis_iters"]) == 1
    masks = np.zeros((len(rgb), 64, 64, 1), np.float32)
    assert vision_data.derive_modalities(rgb, masks=masks,
                                         device="cpu")["mask"] is masks


def test_derive_modalities_in_chunks_is_one_pass(monkeypatch):
    """Rows derived DERIVE_ROWS at a time give what one pass gives."""
    rgb = _faces(3, seed=2)
    whole = vision_data.derive_modalities(rgb, device="cpu")
    monkeypatch.setattr(vision_data, "DERIVE_ROWS", 4)
    stats = {}
    parts = vision_data.derive_modalities(rgb, device="cpu", stats=stats)
    assert len(stats["hysteresis_iters"]) == 2
    for k in whole:
        np.testing.assert_array_equal(parts[k], whole[k], err_msg=k)


# --------------------------------------------------------------------------
# the model: weights, eval mode, the ELBOs
# --------------------------------------------------------------------------

def jax_model(compute_dtype=None, seed=0):
    jm = JaxVision(L, compute_dtype=compute_dtype)
    params, state = jm.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = _randomize_bn(jax.tree_util.tree_map(np.asarray, params), rng)
    state = _randomize_bn(jax.tree_util.tree_map(np.asarray, state), rng)
    return jm, params, state


def port_model(params, state, compute_dtype=None, **kw):
    model = VisionMVAE(L, compute_dtype, device="cpu", **kw)
    sd = state_dict_from_jax("vision", params, state)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                          strict=True)
    return model


@pytest.fixture(scope="module")
def f32():
    jm, params, state = jax_model()
    return jm, params, state, port_model(params, state)


def test_state_dict_keys_are_the_reference_keys(f32):
    ref = torch.nn.Module()
    for m in MODALITIES:
        ref.add_module(f"{m}_encoder",
                       _dcgan_image_encoder(CHANNELS[m], 1, 5, L))
        ref.add_module(f"{m}_decoder",
                       _dcgan_image_decoder(CHANNELS[m], 1, 5, L))
    want = ref.state_dict()
    sd = f32[3].state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].shape == v.shape, k


def test_state_dict_from_jax_is_the_exporter_bit_for_bit(f32):
    _, params, state, _ = f32
    want = export_state_dict("vision", params, state)
    got = state_dict_from_jax("vision", params, state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert checkpoint_family(got, {}) == "vision"
    assert checkpoint_family({k: None for k in got}, {}) == "vision"


def test_encode_and_decode_match_jax(f32):
    """The six posteriors (6, B, L) and the six decoders' logits, f32 at
    rtol 1e-4."""
    jm, params, state, pm = f32
    batch = vision_batch(3, 1)
    mu, lv, _ = jm.encode(params, state, _jax(batch), None, False)
    with torch.no_grad():
        p_mu, p_lv, moments = pm.encode(_torch(batch))
    assert p_mu.shape == (6, 3, L)
    assert moments == {m: [] for m in MODALITIES}
    np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), **TOL)
    z = np.random.default_rng(2).normal(size=(5, L)).astype(np.float32)
    want, _ = jm.decode(params, state, jnp.asarray(z), None, False)
    with torch.no_grad():
        got, _ = pm.decode(torch.from_numpy(z))
    for m in MODALITIES:
        assert got[m].dtype == torch.float32, m
        assert got[m].shape == (5, 64, 64, CHANNELS[m]), m
        # the losses' kernel on the card takes contiguous rows
        assert got[m].reshape(5, -1).is_contiguous(), m
        np.testing.assert_allclose(got[m].numpy(), np.asarray(want[m]),
                                   **TOL, err_msg=m)


@pytest.mark.parametrize("names", [("image",), ("edge",), ("mask",),
                                   ("gray", "watermark"),
                                   ("obscured", "image", "edge"),
                                   MODALITIES])
def test_infer_subsets_match_jax(f32, names):
    jm, params, state, pm = f32
    batch = vision_batch(3, 4)
    mu, lv = jm.infer(params, state, {k: jnp.asarray(batch[k])
                                      for k in names})
    with torch.no_grad():
        p_mu, p_lv = pm.infer({k: torch.from_numpy(batch[k])
                               for k in names})
    np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), **TOL)


@pytest.mark.parametrize("terms", ["joint", "train", "train-no-recon"])
def test_eval_elbo_matches_jax(f32, terms):
    """The CLI's eval ELBO (the joint term, lambdas 1/6), and the 7 train
    terms with RECON_MASKS and without them, f32 at rtol 1e-4."""
    jm, params, state, pm = f32
    masks, lambdas, rmasks = {
        "joint": (EVAL_MASKS, EVAL_LAMBDAS, None),
        "train": (TERM_MASKS, TERM_LAMBDAS, RECON_MASKS),
        "train-no-recon": (TERM_MASKS, TERM_LAMBDAS, None)}[terms]
    batch = vision_batch(B, 6)
    total, per_term = jax_make_eval_step(jm, masks, lambdas,
                                         recon_masks=rmasks)(
        params, state, _jax(batch))
    got, got_terms = make_eval_step(pm, masks, lambdas, device="cpu",
                                    recon_masks=rmasks)(_torch(batch))
    assert got_terms.shape == (len(masks),)
    np.testing.assert_allclose(got_terms.numpy(), np.asarray(per_term),
                               rtol=1e-4)
    np.testing.assert_allclose(float(got), float(total), rtol=1e-4)


def test_recon_masks_score_every_modality_in_a_unimodal_term(f32):
    """Without recon_masks a unimodal term scores its own modality; with
    all ones it scores six: each term's loss is its modalities' weighted
    losses plus the KL, so the joint term agrees and the unimodal terms
    grow by the other five modalities' losses."""
    _, _, _, pm = f32
    batch = _torch(vision_batch(B, 8))
    out = {}
    for rmasks in (None, RECON_MASKS):
        out[rmasks is None] = make_eval_step(
            pm, TERM_MASKS, TERM_LAMBDAS, device="cpu",
            recon_masks=rmasks)(batch)[1].numpy()
    one, six = out[True], out[False]
    np.testing.assert_allclose(one[0], six[0], rtol=1e-6)
    assert (six[1:] > one[1:] + 100).all(), (one, six)


# --------------------------------------------------------------------------
# the train-mode ELBO at T = 7
# --------------------------------------------------------------------------

def jax_noise(key, t, b):
    """The keep-masks (one a modality, fold_in(encoder key, i),
    models/vision.py:103) and eps JAX's multi_term_elbo draws."""
    rngs = jax.random.split(key, 3)
    keep = np.stack([np.asarray(jax.random.bernoulli(
        jax.random.fold_in(rngs[0], i), 0.9, (b, 512))) for i in range(6)])
    eps = np.asarray(jax.random.normal(rngs[1], (t, b, L), jnp.float32))
    return eps, keep


@pytest.fixture(scope="module")
def jax_step():
    """JAX's train-mode ELBO at T = 7 with RECON_MASKS, f32: loss, per
    term, gradients and the state after the EMA commit."""
    jm, params, state = jax_model(seed=1)
    batch_u8 = vision_batch(B, 31, uint8=True)
    key = jax.random.key(7)
    batch = jax_decode_batch(_jax(batch_u8), jnp.float32)

    def loss(p):
        total, aux, new_state = jax_multi_term_elbo(
            jm, p, state, batch, jnp.asarray(TERM_MASKS),
            jnp.asarray(TERM_LAMBDAS), key, 0.7, train=True,
            recon_masks=jnp.asarray(RECON_MASKS))
        return total, (aux["per_term"], new_state)

    (total, (per_term, new_state)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(params=params, state=state, batch_u8=batch_u8,
                noise=jax_noise(key, 7, B), total=float(total),
                per_term=np.asarray(per_term),
                grads=state_dict_from_jax("vision", np_tree(grads), state),
                new_state=state_dict_from_jax("vision", params,
                                              np_tree(new_state)))


@pytest.fixture(scope="module", params=["unfused", "conv_moments"])
def step(request, jax_step):
    """The port's train-mode ELBO on JAX's weights, batch and noise, on the
    encoders' default route or the fused one (the plain conv2d_moments on
    the CPU)."""
    pm = port_model(jax_step["params"], jax_step["state"],
                    conv_moments=request.param == "conv_moments")
    pm.train()
    total, aux = multi_term_elbo(
        pm, decode_batch(_torch(jax_step["batch_u8"])),
        torch.tensor(TERM_MASKS), torch.tensor(TERM_LAMBDAS), 0.7,
        train=True, noise=tuple(torch.from_numpy(a.copy())
                                for a in jax_step["noise"]),
        recon_masks=torch.tensor(RECON_MASKS))
    total.backward()
    return dict(jax_step, p_total=float(total.detach()),
                p_terms=aux["per_term"].detach().numpy(), pm=pm)


def test_train_elbo_matches_jax(step):
    """Total and the 7 per-term values at rtol 1e-4; every gradient within
    5e-5 of JAX's in relative Frobenius norm."""
    np.testing.assert_allclose(step["p_total"], step["total"], rtol=1e-4)
    np.testing.assert_allclose(step["p_terms"], step["per_term"], rtol=1e-4)
    for k, p in step["pm"].named_parameters():
        want = step["grads"][k]
        gap = np.linalg.norm(p.grad.numpy() - want)
        assert gap < 5e-5 * np.linalg.norm(want), (k, gap)


def test_commit_ema_states_matches_jax(step):
    """The running statistics after the step against JAX's new_state:
    each decoder's 7 commits in term order, each encoder's 2 (the joint
    term and its own; term_masks, not RECON_MASKS)."""
    sd = step["pm"].state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 6 * 12
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), step["new_state"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_train_steps_keep_masks_are_one_a_modality():
    """draw_noise draws the (6, B, 512) keep-masks of keep_mask_shape, and
    each encoder's dropout takes its own: a train-mode encode with one
    modality's keep-mask zeroed moves that modality's posterior alone."""
    pm = VisionMVAE(L, device="cpu")
    assert pm.keep_mask_shape(3) == (6, 3, 512) and pm.dropout_rate == 0.1
    eps, keep = loop.draw_noise(pm, 7, 3, torch.Generator().manual_seed(0))
    assert eps.shape == (7, 3, L) and keep.shape == (6, 3, 512)
    batch = decode_batch(_torch(vision_batch(3, 2, uint8=True)))
    pm.train()
    outs = []
    for i in (None, 3):
        k = keep.clone()
        if i is not None:
            k[i] = False
        with torch.no_grad():
            mu, _, moments = pm.encode(batch, k)
        outs.append(mu)
    assert all(len(moments[m]) == 3 for m in MODALITIES)
    moved = [m for j, m in enumerate(MODALITIES)
             if not torch.equal(outs[0][j], outs[1][j])]
    assert moved == [MODALITIES[3]]


# --------------------------------------------------------------------------
# bf16 compute
# --------------------------------------------------------------------------

# Outputs that pass through a bf16 rounding (the conv stacks, the heads):
# each lies closer to JAX in bf16 than BF16_MARGIN times its gap to the
# port in f32 (rel_l1); the eval loss at the f32 tolerance.
BF16_MARGIN = 0.1


def test_bf16_between_its_readings(f32):
    _, params, state, pf = f32
    jm = JaxVision(L, compute_dtype=jnp.bfloat16)
    pb = port_model(params, state, torch.bfloat16)
    batch = vision_batch(B, 11)
    z = np.random.default_rng(10).normal(size=(B, L)).astype(np.float32)
    mu, lv, _ = jm.encode(params, state, _jax(batch), None, False)
    rec, _ = jm.decode(params, state, jnp.asarray(z), None, False)
    _, terms = jax_make_eval_step(jm, EVAL_MASKS, EVAL_LAMBDAS)(
        params, state, _jax(batch))
    want = {"mu": mu, "logvar": lv, **{f"{m} logits": rec[m]
                                      for m in MODALITIES},
            "eval per_term": terms}
    outs = []
    for m in (pb, pf):
        with torch.no_grad():
            p_mu, p_lv, _ = m.encode(_torch(batch))
            p_rec, _ = m.decode(torch.from_numpy(z))
        _, p_terms = make_eval_step(m, EVAL_MASKS, EVAL_LAMBDAS,
                                    device="cpu")(_torch(batch))
        outs.append({"mu": p_mu, "logvar": p_lv, "eval per_term": p_terms,
                     **{f"{k} logits": p_rec[k] for k in MODALITIES}})
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        got_b, got_f = outs[0][name].float().numpy(), outs[1][name].numpy()
        if name == "eval per_term":
            np.testing.assert_allclose(got_b, w, rtol=1e-4)
        else:
            to_jax, to_f32 = rel_l1(got_b, w), rel_l1(got_b, got_f)
            assert to_jax < BF16_MARGIN * to_f32, (name, to_jax, to_f32)


# --------------------------------------------------------------------------
# the IWAE over 49152 logits a joint row
# --------------------------------------------------------------------------

def test_iwae_chunked_decode_matches_jax(f32, monkeypatch):
    """The joint estimate with JAX's own draws at K = 4, B = 2, where a
    cut DECODE_ELEMENTS splits the 8 decoded rows of 49152 logits into 4
    chunks, against JAX's estimate and against one decode, f32 rtol
    1e-4."""
    jm, params, state, pm = f32
    batch = vision_batch(B, 12)
    rng = jax.random.key(17)
    k = 4
    want = jax_iwae(jm, params, state, _jax(batch),
                    jnp.ones(6, jnp.float32), list(MODALITIES), rng, k)
    eps = torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        key, (B, L), jnp.float32)) for key in jax.random.split(rng, k)]))
    args = (pm, _torch(batch), [1.0] * 6, list(MODALITIES), k)
    whole = loglike.iwae_log_marginal(*args, eps=eps)
    assert loglike._row_elements(pm) == 49152
    monkeypatch.setattr(loglike, "DECODE_ELEMENTS", 2 * B * 49152)
    assert loglike.decode_chunks(k, B, 49152) == 2
    monkeypatch.setattr(loglike, "DECODE_ELEMENTS", B * 49152)
    assert loglike.decode_chunks(k, B, 49152) == 4
    got = loglike.iwae_log_marginal(*args, eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6)
    # K = 100 at B = 100, the CLI's: two chunks of 50 samples
    monkeypatch.undo()
    assert loglike.decode_chunks(100, 100, 49152) == 2


# --------------------------------------------------------------------------
# host streaming
# --------------------------------------------------------------------------

N_TRAIN, N_TEST, BATCH, K = 23, 10, 4, 2


def _tiny_sets():
    train = ArrayDataset(vision_batch(N_TRAIN, 40))
    test = ArrayDataset(vision_batch(N_TEST, 41))
    return train, test


def _row_ids(batch):
    """Each row's id: its first gray pixel times 255 (the sets below give
    row i the value i there)."""
    return np.rint(np.asarray(batch["gray"])[:, 0, 0, 0] * 255).astype(int)


def _ided(ds):
    out = {k: v.copy() for k, v in ds.arrays.items()}
    out["gray"][:, 0, 0, 0] = np.arange(len(ds)) / np.float32(255)
    return ArrayDataset(out)


def test_host_streaming_is_jax_order_and_betas(monkeypatch):
    """Both drivers with --no-device-data and stand-in steps over two
    epochs: each step's rows (data/pipeline.py:batches' order) and its KL
    weight (annealing_factor, step by step) equal JAX's; the eval sees the
    test rows in order, the ragged batch too; the log lines agree."""
    train_ds, test_ds = (_ided(d) for d in _tiny_sets())
    argv = ["--n-latents", "8", "--batch-size", str(BATCH), "--log-interval",
            str(K), "--seed", "5", "--epochs", "2", "--annealing-epochs",
            "2", "--no-device-data"]
    want, got, want_ev, got_ev = [], [], [], []

    def jax_train(*_a, **_k):
        def step(params, state, opt_state, rng, batch, beta):
            want.append((_row_ids(batch), beta))
            return (params, state, opt_state, rng,
                    jnp.float32(_row_ids(batch).sum()), None)
        return step

    def jax_eval(*_a, **_k):
        def step(params, state, batch):
            want_ev.append(_row_ids(batch))
            return jnp.float32(_row_ids(batch).sum()), None
        return step

    monkeypatch.setattr(jax_driver, "jax", _OneDevice())
    monkeypatch.setattr(jax_loop, "make_train_step", jax_train)
    monkeypatch.setattr(jax_loop, "make_eval_step", jax_eval)
    monkeypatch.setattr(jax_driver, "save_checkpoint", lambda *a: None)
    jax_args = jax_train_parser(n_latents=8, epochs=2, annealing_epochs=2,
                                lr=1e-4).parse_args(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_driver.run_training(JaxVision(8), train_ds, test_ds, jax_args,
                                TERM_MASKS, TERM_LAMBDAS, out_dir="unused",
                                meta={}, recon_masks=RECON_MASKS)
    jax_text = buf.getvalue()

    def port_train(model, *_a, **_k):
        def step(batch, beta):
            got.append((_row_ids(batch), beta))
            return torch.tensor(float(_row_ids(batch).sum())), None
        step.optimizer = torch.optim.Adam(model.parameters())
        return step

    def port_eval(*_a, **_k):
        def step(batch):
            got_ev.append(_row_ids(batch))
            return torch.tensor(float(_row_ids(batch).sum())), None
        return step

    monkeypatch.setattr(loop, "make_train_step", port_train)
    monkeypatch.setattr(loop, "make_multi_train_step", None)
    monkeypatch.setattr(loop, "make_eval_step", port_eval)
    monkeypatch.setattr(driver, "save_checkpoint", lambda *a: None)
    args = v_train.parse_train_args(v_train.parser(), argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        driver.run_training(VisionMVAE(8, device="cpu"), train_ds, test_ds,
                            args, TERM_MASKS, TERM_LAMBDAS, out_dir="unused",
                            meta={}, device="cpu", recon_masks=RECON_MASKS)
    text = buf.getvalue()
    assert len(want) == 2 * (N_TRAIN // BATCH) == len(got)
    for (gi, gb), (wi, wb) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert gb == wb
    assert [w[1] for w in want[:3]] == [1 / 10, 2 / 10, 3 / 10]
    assert len(got_ev) == len(want_ev) == 2 * 3
    for g, w in zip(got_ev, want_ev):
        np.testing.assert_array_equal(g, w)
    logs = [ln for ln in text.splitlines() if ln.startswith(("Train", "===="))
            and "Throughput" not in ln]
    assert logs == [ln for ln in jax_text.splitlines()
                    if ln.startswith(("Train", "===="))
                    and "Throughput" not in ln]
    assert "input pipeline: host streaming (--no-device-data" in text


def test_host_streaming_draws_celeba19_terms_as_jax(monkeypatch):
    """A family with sampled terms (celeba19) streamed from the host: each
    step draws its (21, 19) masks and lambdas from default_rng(seed + 1)
    as JAX's host epoch does (driver.py:309-313), bit for bit, over two
    epochs."""
    from mvae_tpu.core import subsets as jax_subsets
    from mvae_tpu.models.celeba19 import Celeba19MVAE as JaxCeleba19
    from mvae_tpu_torch.core import subsets
    from mvae_tpu_torch.experiments.celeba19 import train as c19_train
    from mvae_tpu_torch.models import Celeba19MVAE
    train_ds = synthetic_celeba(N_TRAIN, seed=0)
    test_ds = synthetic_celeba(N_TEST, seed=1)
    argv = ["--n-latents", "8", "--batch-size", str(BATCH), "--seed", "5",
            "--epochs", "2", "--no-device-data"]
    want, got = [], []

    def jax_train(*_a, **_k):
        def step(params, state, opt_state, rng, batch, beta, masks,
                 lambdas):
            want.append((np.asarray(masks), np.asarray(lambdas)))
            return params, state, opt_state, rng, jnp.float32(0.0), None
        return step

    monkeypatch.setattr(jax_driver, "jax", _OneDevice())
    monkeypatch.setattr(jax_loop, "make_train_step", jax_train)
    monkeypatch.setattr(jax_loop, "make_eval_step", lambda *a, **k: (
        lambda params, state, batch: (jnp.float32(0.0), None)))
    monkeypatch.setattr(jax_driver, "save_checkpoint", lambda *a: None)
    jax_args = jax_train_parser(n_latents=8, epochs=2, annealing_epochs=1,
                                lr=1e-4).parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        jax_driver.run_training(
            JaxCeleba19(8), train_ds, test_ds, jax_args,
            *jax_subsets.celeba19_static_terms(18, 1.0, 10.0),
            out_dir="unused", meta={}, make_masks=lambda rng: (
                jax_subsets.celeba19_step_terms(rng, 1, 18, 1.0, 10.0)))

    def port_train(model, *_a, **_k):
        def step(batch, beta, masks=None, lambdas=None):
            got.append((masks.numpy(), lambdas.numpy()))
            return torch.tensor(0.0), None
        step.optimizer = torch.optim.Adam(model.parameters())
        return step

    monkeypatch.setattr(loop, "make_train_step", port_train)
    monkeypatch.setattr(loop, "make_eval_step", lambda *a, **k: (
        lambda batch: (torch.tensor(0.0), None)))
    monkeypatch.setattr(driver, "save_checkpoint", lambda *a: None)
    args = c19_train.parse_train_args(c19_train.parser(), argv)
    with contextlib.redirect_stdout(io.StringIO()):
        driver.run_training(
            Celeba19MVAE(8, device="cpu"), train_ds, test_ds, args,
            *subsets.celeba19_static_terms(18, 1.0, 10.0), out_dir="unused",
            meta={}, device="cpu", make_masks=lambda rng: (
                subsets.celeba19_step_terms(rng, 1, 18, 1.0, 10.0)))
    assert len(got) == len(want) == 2 * (N_TRAIN // BATCH)
    for (gm, gl), (wm, wl) in zip(got, want):
        assert gm.shape == (21, 19)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gl, wl)


def test_driver_streams_over_the_budget(monkeypatch):
    """Sets whose reckoned bytes (float images as uint8) reach
    DEVICE_DATA_BUDGET stream from the host without the flag; under it
    they stay resident."""
    train_ds, test_ds = _tiny_sets()
    reckoned = driver.reckoned_bytes(train_ds) + driver.reckoned_bytes(
        test_ds)
    assert reckoned == (N_TRAIN + N_TEST) * 64 * 64 * 12
    seen = []
    monkeypatch.setattr(loop, "make_train_step",
                        lambda m, *a, **k: seen.append("host") or 1 / 0)
    monkeypatch.setattr(loop, "make_multi_train_step",
                        lambda m, *a, **k: seen.append("resident") or 1 / 0)
    args = v_train.parse_train_args(v_train.parser(), ["--device", "cpu"])
    for budget, path in ((reckoned + 1, "resident"), (reckoned, "host")):
        monkeypatch.setattr(driver, "DEVICE_DATA_BUDGET", budget)
        with pytest.raises(ZeroDivisionError):
            driver.run_training(VisionMVAE(8, device="cpu"), train_ds,
                                test_ds, args, TERM_MASKS, TERM_LAMBDAS,
                                out_dir="unused", meta={}, device="cpu")
        assert seen[-1] == path


def test_resident_and_streamed_paths_give_one_loss():
    """On rows whose floats are multiples of 1/255 (so the resident
    uint8 decodes to the same f32), one train step from the same weights
    and noise gives the same loss and the same weights after, bit for
    bit, and the eval over the test set gives the same loss."""
    train_ds, test_ds = _tiny_sets()
    base = VisionMVAE(L, device="cpu")
    eps, keep = loop.draw_noise(base, 7, BATCH,
                                torch.Generator().manual_seed(3))
    rows = np.array([5, 1, 17, 9])
    out = []
    for resident in (True, False):
        model = copy.deepcopy(base)
        step = make_train_step(model, TERM_MASKS, TERM_LAMBDAS, lr=1e-4,
                               generator=None, device="cpu",
                               device_data=resident, recon_masks=RECON_MASKS)
        if resident:
            batch = (driver.to_device_data(train_ds, "cpu"),
                     torch.from_numpy(rows))
        else:
            batch = driver.to_device_batch(
                {k: v[rows] for k, v in train_ds.arrays.items()}, "cpu")
        loss, _ = step(batch, 0.5, (eps, keep))
        ev = make_eval_step(model, EVAL_MASKS, EVAL_LAMBDAS, device="cpu",
                            device_data=resident)
        test = (driver.evaluate(ev, driver.to_device_data(test_ds, "cpu"),
                                N_TEST, BATCH) if resident else
                driver.evaluate_host(ev, test_ds, BATCH, "cpu"))
        out.append((loss.item(), test, model.state_dict()))
    assert out[0][0] == out[1][0] and out[0][1] == out[1][1]
    for k, v in out[0][2].items():
        assert torch.equal(v, out[1][2][k]), k


# --------------------------------------------------------------------------
# the CLIs on the CPU over a tiny synthetic set
# --------------------------------------------------------------------------

CLI_FLAGS = ["--device", "cpu", "--n-latents", str(L), "--batch-size", "5",
             "--log-interval", "2", "--annealing-epochs", "1", "--seed", "3",
             "--f32"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = main(argv)
    return value, buf.getvalue()


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The train CLI on 20 / 10 synthetic CelebA rows (their six
    modalities derived on the CPU) for 2 epochs, --resume for a third, and
    one epoch from the start with --no-device-data; (out dir, stdout of
    both, tmp)."""
    tmp = tmp_path_factory.mktemp("vision")
    sets = {"train": synthetic_celeba(20, seed=0),
            "val": synthetic_celeba(10, seed=1),
            "test": synthetic_celeba(10, seed=2)}
    mp = pytest.MonkeyPatch()
    mp.setattr(vision_data, "load_celeba", lambda data_dir, part, **kw:
               sets[part])
    mp.setattr(torch.backends.cudnn, "allow_tf32",
               torch.backends.cudnn.allow_tf32)
    texts = {}
    for name, extra in (("resident", []), ("host", ["--no-device-data"])):
        out = str(tmp / name)
        flags = CLI_FLAGS + extra + ["--out-dir", out, "--data-dir",
                                     str(tmp)]
        text = _run(v_train.main, flags + [
            "--epochs", "2" if name == "resident" else "1"])[1]
        if name == "resident":
            text += _run(v_train.main, flags + [
                "--epochs", "3", "--resume", os.path.join(out, CKPT)])[1]
        texts[name] = text
    yield str(tmp / "resident"), texts, tmp
    mp.undo()


def test_cli_trains_resumes_and_dumps_reconstructions(cli_run):
    out, texts, _ = cli_run
    text = texts["resident"]
    assert f"resumed from {os.path.join(out, CKPT)} at epoch 2" in text
    assert "input pipeline: device-resident" in text
    tests = [float(ln.split()[-1]) for ln in text.splitlines()
             if ln.startswith("====> Test Loss")]
    assert len(tests) == 3 and all(np.isfinite(tests))
    assert "Train Epoch: 3 [0/20" in text
    ckpt = torch.load(os.path.join(out, CKPT), map_location="cpu",
                      weights_only=True)
    assert ckpt["model"] == "vision" and ckpt["epoch"] == 3
    for e in (1, 2, 3):
        png = os.path.join(out, "reconstructions", f"epoch_{e}.png")
        with open(png, "rb") as f:
            head = f.read(24)
        assert head[:8] == b"\x89PNG\r\n\x1a\n"
        # 6 rows of 8 images of 64, padded by 2: 8 * 66 + 2 wide
        assert int.from_bytes(head[16:20], "big") == 530
        assert int.from_bytes(head[20:24], "big") == 398


def test_cli_streams_from_the_host(cli_run):
    """--no-device-data trains an epoch with the host's log lines: a train
    line every --log-interval steps (0 and 2 of 4), the epoch and test
    lines, the grid and the files."""
    _, texts, tmp = cli_run
    text = texts["host"]
    assert ("input pipeline: host streaming (--no-device-data; "
            in text)
    assert [ln.split("\t")[0] for ln in text.splitlines()
            if ln.startswith("Train Epoch")] == [
        "Train Epoch: 1 [0/20 (0%)]", "Train Epoch: 1 [10/20 (50%)]"]
    assert "====> Epoch: 1\t" in text
    tests = [float(ln.split()[-1]) for ln in text.splitlines()
             if ln.startswith("====> Test Loss")]
    assert len(tests) == 1 and np.isfinite(tests[0])
    assert os.path.isfile(tmp / "host" / "reconstructions" / "epoch_1.png")
    assert os.path.isfile(tmp / "host" / BEST)


@pytest.mark.parametrize("ctype", MODALITIES)
def test_cli_samples_conditioned_on_each_modality(cli_run, tmp_path, ctype):
    out, _, _ = cli_run
    rgb = (np.random.default_rng(5).random((80, 72, 3)) * 255).astype(
        np.uint8)
    from PIL import Image
    Image.fromarray(rgb).save(tmp_path / "cond.png")
    res, _ = _run(v_sample.main, [
        os.path.join(out, BEST), "--device", "cpu", "--n-samples", "3",
        "--out-dir", str(tmp_path), "--condition-file",
        str(tmp_path / "cond.png"), "--condition-type", ctype])
    for m in MODALITIES:
        assert res[m].shape == (3, 64, 64, CHANNELS[m])
        assert bool(((res[m] >= 0) & (res[m] <= 1)).all())
        assert (tmp_path / "samples" / f"sample_{m}.png").read_bytes()[
            :8] == b"\x89PNG\r\n\x1a\n"
    cond = v_sample.load_condition(str(tmp_path / "cond.png"), ctype,
                                   device="cpu")
    assert cond.shape == (1, 64, 64, CHANNELS[ctype])


def test_cli_loglike_joint(cli_run):
    out, _, _ = cli_run
    ll, text = _run(v_loglike.main, [
        os.path.join(out, BEST), "--device", "cpu", "--target", "joint",
        "--n-samples", "3", "--batch-size", "4", "--max-examples", "6"])
    assert np.isfinite(ll) and ll < 0
    assert f"====> log p(joint) >= {ll:.4f}  (K=3, N=8)" in text


def test_setup_cli_writes_each_variant(tmp_path):
    """grayscale, edge and mask PNGs for a directory of two images, the
    mask from a landmarks file for one and the white canvas for the
    other; the PNGs hold JAX's gray and the masks bit for bit."""
    from PIL import Image
    src = tmp_path / "in"
    src.mkdir()
    faces = (_faces(1, seed=3) * 255).astype(np.uint8)
    for i, img in enumerate(faces):
        Image.fromarray(img).save(src / f"{i}.png")
    lms = vision_data.synthetic_landmarks(seed=4)
    np.savez(tmp_path / "lms.npz", **{"0.png": lms})
    for kind in ("grayscale", "edge", "mask"):
        extra = ["--landmarks", str(tmp_path / "lms.npz")] if kind == \
            "mask" else []
        _run(v_setup.main, [kind, str(src), str(tmp_path / kind),
                            "--device", "cpu"] + extra)
        assert sorted(os.listdir(tmp_path / kind)) == ["0.png", "1.png"]
    rgb = faces.astype(np.float32) / 255.0
    gray = np.asarray(JT.rgb_to_grayscale(jnp.asarray(rgb)))[..., 0]
    for i in range(2):
        with Image.open(tmp_path / "grayscale" / f"{i}.png") as im:
            got = np.asarray(im)
        want = (np.clip(gray[i], 0, 1) * 255 + 0.5).astype(np.uint8)
        assert np.abs(got.astype(int) - want).max() <= 1
        with Image.open(tmp_path / "edge" / f"{i}.png") as im:
            assert set(np.unique(np.asarray(im))) <= {0, 255}
        with Image.open(tmp_path / "mask" / f"{i}.png") as im:
            want = JT.landmark_mask(64, 64, lms if i == 0 else None)[..., 0]
            np.testing.assert_array_equal(np.asarray(im),
                                          (want * 255).astype(np.uint8))


def test_cli_checkpoint_loads_into_jax(cli_run, tmp_path):
    """model_best.pth.tar read by the JAX package's importer gives the
    port's posteriors (f32, the golden tolerance), and Sampler serves it
    at every endpoint."""
    out, _, _ = cli_run
    src = os.path.join(out, BEST)
    path, meta = import_checkpoint("vision", src, str(tmp_path))
    assert meta["n_latents"] == L
    jm, params, state, _ = jax_load_model(path, JaxVision)
    pm, _ = load_model_checkpoint(src, VisionMVAE, device="cpu")
    batch = vision_batch(3, 14)
    for names in (("image",), ("mask", "edge"), MODALITIES):
        mu, lv = jm.infer(params, state, {k: jnp.asarray(batch[k])
                                          for k in names})
        with torch.no_grad():
            p_mu, p_lv = pm.infer({k: torch.from_numpy(batch[k])
                                   for k in names})
        np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), **TOL)
        np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), **TOL)
    sampler = Sampler.from_checkpoint(src, device="cpu")
    assert type(sampler.model) is VisionMVAE
    assert sampler.sample(2, {"edge": batch["edge"][:1]})["gray"].shape == \
        (2, 64, 64, 1)
    mu, _ = sampler.embed({"image": batch["image"]})
    assert mu.shape == (3, L)
    assert sampler.reconstruct({"mask": batch["mask"]})["image"].shape == \
        (3, 64, 64, 3)
