"""The port's CelebA-19 family against the JAX package on the CPU: the
sampled subset terms and train/driver.py's per-window mask sequence (bit for
bit), the reference keys and the expert-axis carry-across, encode,
decode and infer with an attribute mask, the (N, 19) losses, the eval
ELBO at T = 1 and at T = 21 with a sampled term, one train-mode ELBO at
T = 21 with JAX's noise (loss, gradients, the EMA commit), the same under
--fast-term-decode against JAX's fast mode (the image decoder's running
statistics too), the BCE's bf16-math mode against JAX's bf16 branch
(values and gradients between their gaps), bf16 compute between its two
readings, and the CLIs on `--device cpu` over tiny synthetic sets, whose
checkpoint the JAX package's importer reads.

Same weights (`state_dict_from_jax`, BN randomized) and same numpy inputs
on both sides, at B <= 4 and n_latents 8 with the family's real widths.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvae_tpu.train.driver as jax_driver
import mvae_tpu.train.loop as jax_loop
from mvae_tpu.core import subsets as jax_subsets
from mvae_tpu.core.engine import multi_term_elbo as jax_multi_term_elbo
from mvae_tpu.core.losses import bce_row_sum as jax_bce_row_sum
from mvae_tpu.models.celeba19 import Celeba19MVAE as JaxCeleba19
from mvae_tpu.train.driver import load_model_checkpoint as jax_load_model
from mvae_tpu.train.loop import decode_batch as jax_decode_batch
from mvae_tpu.train.loop import make_eval_step as jax_make_eval_step
from mvae_tpu.utils.cli import train_parser as jax_train_parser
from mvae_tpu.utils.torch_export import export_state_dict
from mvae_tpu.utils.torch_import import import_checkpoint

import mvae_tpu_torch.experiments.celeba19.loglike as c19_loglike
import mvae_tpu_torch.experiments.celeba19.sample as c19_sample
import mvae_tpu_torch.experiments.celeba19.train as c19_train
import mvae_tpu_torch.train.driver as driver
import mvae_tpu_torch.train.loop as loop
from mvae_tpu_torch.core import subsets
from mvae_tpu_torch.core.engine import decode_plan, multi_term_elbo
from mvae_tpu_torch.core.losses import bce_row_sum
from mvae_tpu_torch.data.celeba import synthetic_celeba
from mvae_tpu_torch.models import Celeba19MVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.checkpoint import BEST, CKPT
from mvae_tpu_torch.train.driver import load_model_checkpoint
from mvae_tpu_torch.train.loop import decode_batch, make_eval_step
from mvae_tpu_torch.utils.weights import checkpoint_family, state_dict_from_jax

from tests.test_torch_import import _build_celeba19
from tests.test_torch_port_driver import _OneDevice, _attr_sums
from tests.test_torch_port_modules import (
    TOL, _randomize_bn, celeba_batch, rel_l1)

L, B = 8, 2
M = 19
LAMBDAS = (1.0, 10.0)          # the CLI's lambda image and attrs
SUPPORT = subsets.celeba19_recon_support(1)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The port's side on one intra-op thread, restored after (see
    tests/test_torch_port_families.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_model(compute_dtype=None, seed=0):
    jm = JaxCeleba19(L, compute_dtype=compute_dtype)
    params, state = jm.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = _randomize_bn(jax.tree_util.tree_map(np.asarray, params), rng)
    state = _randomize_bn(jax.tree_util.tree_map(np.asarray, state), rng)
    return jm, params, state


def port_model(params, state, compute_dtype=None, **kw):
    model = Celeba19MVAE(L, compute_dtype, device="cpu", **kw)
    sd = state_dict_from_jax("celeba19", params, state)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                          strict=True)
    return model


def step_terms(seed):
    """One step's (21, 19) masks and lambdas with one sampled term."""
    return subsets.celeba19_step_terms(np.random.default_rng(seed), 1, 18,
                                       *LAMBDAS)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def f32():
    jm, params, state = jax_model()
    return jm, params, state, port_model(params, state)


# --------------------------------------------------------------------------
# the sampled terms and train/driver.py's mask sequence
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,seed", [(1, 19, 0), (5, 19, 1), (40, 19, 2),
                                      (6, 4, 3)])
def test_subset_masks_are_jax_bit_for_bit(m, n, seed):
    """sample_subset_masks from one Generator state, and the fixed terms,
    the recon support and a step's terms, equal the JAX package's."""
    got = subsets.sample_subset_masks(np.random.default_rng(seed), m, n)
    want = jax_subsets.sample_subset_masks(np.random.default_rng(seed), m, n)
    assert got.dtype == want.dtype and got.shape == (m, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(subsets.celeba19_recon_support(m),
                                  jax_subsets.celeba19_recon_support(m))
    for a, b in zip(subsets.celeba19_static_terms(18, 2.0, 5.0),
                    jax_subsets.celeba19_static_terms(18, 2.0, 5.0)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(subsets.celeba19_step_terms(
            np.random.default_rng(seed), m, 18, 1.0, 10.0),
            jax_subsets.celeba19_step_terms(np.random.default_rng(seed), m,
                                            18, 1.0, 10.0)):
        np.testing.assert_array_equal(a, b)


N_TRAIN, N_TEST, BATCH, K = 23, 10, 4, 2


def _masks_fn(module, m=1):
    return lambda rng: module.celeba19_step_terms(rng, m, 18, *LAMBDAS)


def test_driver_mask_sequence_matches_jax(monkeypatch):
    """Both drivers with stand-in steps over two epochs of windows 2, 2, 1:
    each window's (k, 21, 19) masks and lambdas, drawn k at a time from
    default_rng(seed + 1), equal JAX's bit for bit."""
    train_ds = synthetic_celeba(N_TRAIN, seed=0)
    test_ds = synthetic_celeba(N_TEST, seed=1)
    argv = ["--n-latents", "8", "--batch-size", str(BATCH), "--log-interval",
            str(K), "--seed", "5", "--epochs", "2"]
    got, want = [], []

    def jax_multi(*_a, **_k):
        def step(params, state, opt_state, rng, data, idxs, betas, masks,
                 lambdas):
            want.append((np.asarray(masks), np.asarray(lambdas)))
            return (params, state, opt_state, rng, jnp.asarray(_attr_sums(
                data["attrs"][0], np.asarray(idxs)[:, 0, :])))
        return step

    monkeypatch.setattr(jax_driver, "jax", _OneDevice())
    monkeypatch.setattr(jax_loop, "make_multi_train_step", jax_multi)
    monkeypatch.setattr(jax_loop, "make_multi_eval_step", lambda *a, **k: (
        lambda params, state, data, idxs: jnp.zeros(len(idxs))))
    monkeypatch.setattr(jax_loop, "make_eval_step", lambda *a, **k: (
        lambda params, state, batch: (jnp.float32(0.0), None)))
    monkeypatch.setattr(jax_driver, "save_checkpoint", lambda *a: None)
    args = jax_train_parser(n_latents=8, epochs=2, annealing_epochs=1,
                            lr=1e-4).parse_args(argv)
    static = jax_subsets.celeba19_static_terms(18, *LAMBDAS)
    with contextlib.redirect_stdout(io.StringIO()):
        jax_driver.run_training(JaxCeleba19(8), train_ds, test_ds, args,
                                *static, out_dir="unused", meta={},
                                make_masks=_masks_fn(jax_subsets))

    def port_multi(model, *_a, **_k):
        def step(data, idxs, betas, masks=None, lambdas=None):
            got.append((masks.numpy(), lambdas.numpy()))
            return torch.from_numpy(_attr_sums(data["attrs"], idxs))
        step.optimizer = torch.optim.Adam(model.parameters())
        return step

    monkeypatch.setattr(loop, "make_multi_train_step", port_multi)
    monkeypatch.setattr(loop, "make_eval_step", lambda *a, **k: (
        lambda batch: (torch.tensor(0.0), None)))
    monkeypatch.setattr(driver, "save_checkpoint", lambda *a: None)
    args = c19_train.parse_train_args(c19_train.parser(), argv + [
        "--annealing-epochs", "1"])
    static = subsets.celeba19_static_terms(18, *LAMBDAS)
    with contextlib.redirect_stdout(io.StringIO()):
        driver.run_training(Celeba19MVAE(8, device="cpu"), train_ds, test_ds,
                            args, *static, out_dir="unused", meta={},
                            device="cpu", make_masks=_masks_fn(subsets))
    assert len(want) == 2 * 3 and [len(w[0]) for w in want[:3]] == [2, 2, 1]
    assert len(got) == len(want)
    for (gm, gl), (wm, wl) in zip(got, want):
        assert gm.shape == wm.shape == (len(wm), 21, M)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gl, wl)
    assert not np.array_equal(want[0][0][0, 20], want[1][0][0, 20])


# --------------------------------------------------------------------------
# weights, modules, losses, the eval ELBO (f32)
# --------------------------------------------------------------------------

def test_state_dict_keys_are_the_reference_keys(f32):
    ref = _build_celeba19(L).state_dict()
    sd = f32[3].state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert sd[k].shape == v.shape, k


def test_state_dict_from_jax_is_the_exporter_bit_for_bit(f32):
    _, params, state, _ = f32
    want = export_state_dict("celeba19", params, state)
    got = state_dict_from_jax("celeba19", params, state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert checkpoint_family(got, {}) == "celeba19"


def test_encode_and_decode_match_jax(f32):
    """The 19 posteriors (M, B, L) and the image and attribute logits,
    f32 at rtol 1e-4."""
    jm, params, state, pm = f32
    batch = celeba_batch(3, 1)
    mu, lv, _ = jm.encode(params, state, _jax(batch), None, False)
    with torch.no_grad():
        p_mu, p_lv, moments = pm.encode(_torch(batch))
    assert p_mu.shape == (M, 3, L) and moments == {"image": []}
    np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), **TOL)
    z = np.random.default_rng(2).normal(size=(5, L)).astype(np.float32)
    want, _ = jm.decode(params, state, jnp.asarray(z), None, False)
    with torch.no_grad():
        got, _ = pm.decode(torch.from_numpy(z))
    for k, shape in (("image", (5, 64, 64, 3)), ("attrs", (5, 18))):
        assert got[k].dtype == torch.float32 and got[k].shape == shape, k
        # the losses' kernel on the card takes contiguous rows
        assert got[k].reshape(5, -1).is_contiguous(), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("names,mask", [
    (("image",), None), (("attrs",), None), (("attrs",), 14),
    (("image", "attrs"), 3), (("image", "attrs"), None)])
def test_infer_with_an_attribute_mask_matches_jax(f32, names, mask):
    """infer over the image and the attribute experts an attrs_mask names
    (celeba19/model.py:63-89): one attribute alone, all of them, none."""
    jm, params, state, pm = f32
    batch = celeba_batch(3, 4)
    am = None
    if mask is not None:
        am = np.zeros(18, np.float32)
        am[mask] = 1.0
    mu, lv = jm.infer(params, state, {k: jnp.asarray(batch[k])
                                      for k in names},
                      attrs_mask=None if am is None else jnp.asarray(am))
    with torch.no_grad():
        p_mu, p_lv = pm.infer({k: torch.from_numpy(batch[k])
                               for k in names}, attrs_mask=am)
    np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), **TOL)


def test_recon_losses_match_jax(f32):
    """(N, 19) loss rows on 3 * B logit rows against B shared target rows,
    against JAX's on the repeated targets; the IWAE's per-input losses."""
    jm, _, _, pm = f32
    batch = celeba_batch(B, 3)
    rng = np.random.default_rng(4)
    recons = {"image": (3 * rng.normal(size=(3 * B, 64, 64, 3))).astype(
        np.float32), "attrs": (3 * rng.normal(size=(3 * B, 18))).astype(
        np.float32)}
    rep = {k: np.concatenate([v] * 3) for k, v in batch.items()}
    want = jm.recon_losses(_jax(recons), _jax(rep))
    got = pm.recon_losses(_torch(recons), _torch(batch))
    assert got.shape == (3 * B, M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in pm.loglike_targets:
        np.testing.assert_allclose(
            pm.recon_loss(name, torch.from_numpy(recons[name]),
                          torch.from_numpy(batch[name])).numpy(),
            np.asarray(jm.recon_loss(name, jnp.asarray(recons[name]),
                                     jnp.asarray(rep[name]))), **TOL)


@pytest.mark.parametrize("terms", ["joint", "step"])
def test_eval_elbo_matches_jax(f32, terms):
    """The eval ELBO of the CLI's joint term (lambdas 1) and of a whole
    step's 21 terms with a sampled one, f32 at rtol 1e-4."""
    jm, params, state, pm = f32
    if terms == "joint":
        masks = lambdas = np.ones((1, M), np.float32)
    else:
        masks, lambdas = step_terms(6)
    batch = celeba_batch(B, 6)
    total, per_term = jax_make_eval_step(jm, masks, lambdas)(
        params, state, _jax(batch))
    got, got_terms = make_eval_step(pm, masks, lambdas, device="cpu")(
        _torch(batch))
    assert got_terms.shape == (len(masks),)
    np.testing.assert_allclose(got_terms.numpy(), np.asarray(per_term),
                               rtol=1e-4)
    np.testing.assert_allclose(float(got), float(total), rtol=1e-4)


# --------------------------------------------------------------------------
# the train-mode ELBO at T = 21, reference-exact and fast
# --------------------------------------------------------------------------

def jax_noise(key, t, b):
    """The image head's keep-mask and eps JAX's multi_term_elbo draws."""
    rngs = jax.random.split(key, 3)
    keep = jax.random.bernoulli(rngs[0], 0.9, (b, 512))
    eps = jax.random.normal(rngs[1], (t, b, L), jnp.float32)
    return np.array(eps), np.array(keep)


@pytest.fixture(scope="module", params=["exact", "fast"])
def step(request):
    """One train-mode ELBO at T = 21 in f32 on both sides, from the same
    weights, batch, masks and JAX noise: reference-exact (JAX's ungrouped
    form; the port's one-batch decode) or --fast-term-decode (JAX's
    grouped form with its skip; the port's decode_plan with it)."""
    fast = request.param == "fast"
    jm, params, state = jax_model(seed=1)
    masks, lambdas = step_terms(9)
    batch_u8 = celeba_batch(B, 31, uint8=True)
    key = jax.random.key(7)
    batch = jax_decode_batch(_jax(batch_u8), jnp.float32)

    def loss(p):
        total, aux, new_state = jax_multi_term_elbo(
            jm, p, state, batch, jnp.asarray(masks), jnp.asarray(lambdas),
            key, 0.7, train=True, recon_support=SUPPORT if fast else None,
            fast_skip_decode=fast)
        return total, (aux["per_term"], new_state)

    (total, (per_term, new_state)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    pm = port_model(params, state)
    pm.train()
    plan = (decode_plan(pm, SUPPORT, fast_skip_decode=True) if fast
            else None)
    p_total, aux = multi_term_elbo(
        pm, decode_batch(_torch(batch_u8)), torch.tensor(masks),
        torch.tensor(lambdas), 0.7, train=True,
        noise=tuple(torch.from_numpy(a) for a in jax_noise(key, 21, B)),
        plan=plan)
    p_total.backward()
    want_sd = state_dict_from_jax(
        "celeba19", params, jax.tree_util.tree_map(np.asarray, new_state))
    return dict(fast=fast, total=float(total), per_term=np.asarray(per_term),
                grads=state_dict_from_jax("celeba19", jax.tree_util.tree_map(
                    np.asarray, grads), state), new_state=want_sd,
                p_total=float(p_total.detach()),
                p_terms=aux["per_term"].detach().numpy(), pm=pm)


def test_train_elbo_matches_jax(step):
    """Total and the 21 per-term values at rtol 1e-4; every gradient
    within 5e-5 of JAX's in relative Frobenius norm (the largest read
    1.4e-5, an attribute decoder's bias); in fast mode the same values,
    as the skipped decodes carry no loss weight, and the gradients within
    5e-4, JAX's own bound for the gathered experts (tests/test_celeba19.py
    :181-210): the single-attribute terms decode their one expert apart
    from the terms that decode all 18, so an expert's gradient adds the
    two calls' sums, where the one batch and JAX sum the rows in one
    reduction; expert 3's last bias, whose rows' terms of size 1 cancel
    to 6.5e-4, then reads 3.7e-4 (2.4e-7 absolute)."""
    np.testing.assert_allclose(step["p_total"], step["total"], rtol=1e-4)
    np.testing.assert_allclose(step["p_terms"], step["per_term"], rtol=1e-4)
    rtol = 5e-4 if step["fast"] else 5e-5
    for k, p in step["pm"].named_parameters():
        want = step["grads"][k]
        gap = np.linalg.norm(p.grad.numpy() - want)
        assert gap < rtol * np.linalg.norm(want), (k, gap)


def test_commit_ema_states_matches_jax(step):
    """The running statistics after the step against JAX's new_state: the
    image decoder's 21 commits in term order (fast: the 18 skipped terms'
    as JAX commits a skipped term), the image encoder's k of them."""
    sd = step["pm"].state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 12
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), step["new_state"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_fast_term_decode_moves_only_the_image_decoder_statistics():
    """The fast plan decodes the image of the terms whose support holds
    it alone (the complete, image-only and sampled terms), and one step in
    each mode from the same start differs in the image decoder's running
    statistics only."""
    plan = decode_plan(Celeba19MVAE(L, device="cpu"), SUPPORT,
                       fast_skip_decode=True)
    assert [c.index for c in plan[0].calls] == [(0, 1, 20)]
    _, params, state = jax_model(seed=2)
    masks, lambdas = (torch.tensor(a) for a in step_terms(3))
    batch = decode_batch(_torch(celeba_batch(B, 5, uint8=True)))
    noise = tuple(torch.from_numpy(a) for a in jax_noise(
        jax.random.key(3), 21, B))
    stats = []
    for fast in (False, True):
        pm = port_model(params, state)
        pm.train()
        multi_term_elbo(pm, batch, masks, lambdas, 1.0, train=True,
                        noise=noise, plan=plan if fast else None)
        stats.append({k: v for k, v in pm.state_dict().items()
                      if "running" in k})
    for k in stats[0]:
        same = torch.equal(stats[0][k], stats[1][k])
        assert same != k.startswith("image_decoder"), k


# --------------------------------------------------------------------------
# the BCE's bf16 math
# --------------------------------------------------------------------------

# The port's bf16 steps against JAX's bf16 branch (MVAE_BF16_LOSS=1): each
# reading lies closer to it than BF16_MARGIN times the port's f32 math on
# the same bf16 logits does (rel_l1), values and gradients. Readings on the
# CPU: the row sums 1.2e-8 to 7.1e-8 from JAX (the f32 sums' order) against
# 1.4e-4 to 1.7e-4 from the f32 math; the gradients equal JAX's bit for bit
# (0) against 3.1e-3 to 3.4e-3.
BF16_MARGIN = 0.1


@pytest.mark.parametrize("n,nt,k", [(6, 6, 12288), (8, 2, 12288),
                                    (6, 3, 2500)])
def test_bf16_math_bce_between_its_gaps(monkeypatch, n, nt, k):
    """Row sums and the logits' gradient (upstream weights per row) of the
    bf16-math BCE with bf16 logits and targets, rows shared as the ELBO
    shares them, against JAX's bf16 branch on the repeated targets."""
    rng = np.random.default_rng(n + k)
    x = (3 * rng.normal(size=(n, k))).astype(np.float32)
    t = rng.random((nt, k)).astype(np.float32)
    w = rng.normal(size=n).astype(np.float32)
    xb, tb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(t, jnp.bfloat16)
    trep = jnp.concatenate([tb] * (n // nt))
    monkeypatch.setenv("MVAE_BF16_LOSS", "1")
    want = np.asarray(jax_bce_row_sum(xb, trep))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(
        jnp.asarray(w) * jax_bce_row_sum(a, trep)))(xb), np.float32)
    monkeypatch.delenv("MVAE_BF16_LOSS")
    got, grad = {}, {}
    for mode in (True, False):
        xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
        tt = torch.from_numpy(t).to(torch.bfloat16)
        out = bce_row_sum(xt, tt, bf16_math=mode)
        (out * torch.from_numpy(w)).sum().backward()
        assert out.dtype == torch.float32 and xt.grad.dtype == torch.bfloat16
        got[mode], grad[mode] = out.detach().numpy(), xt.grad.float().numpy()
    for name, mine, plain, ref in (("rows", got[True], got[False], want),
                                   ("grad", grad[True], grad[False],
                                    want_g)):
        to_jax, to_f32 = rel_l1(mine, ref), rel_l1(mine, plain)
        assert to_f32 > 0 and to_jax < BF16_MARGIN * to_f32, (
            name, to_jax, to_f32)


def test_bf16_math_takes_f32_logits_as_f32():
    """f32 logits take the f32 math whatever bf16_math says, as JAX's
    branch does."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((3 * rng.normal(size=(4, 300))).astype(np.float32))
    t = torch.from_numpy(rng.random((2, 300)).astype(np.float32))
    assert torch.equal(bce_row_sum(x, t, bf16_math=True), bce_row_sum(x, t))


def test_train_step_bf16_loss_is_the_model_argument(monkeypatch):
    """The model's bf16_loss reaches the image BCE of the bf16 train step
    (and not the attributes' or an eval step's): the step's loss moves
    with it, and no environment variable is read."""
    monkeypatch.setenv("MVAE_BF16_LOSS", "0")
    _, params, state = jax_model(seed=3)
    masks, lambdas = (torch.tensor(a) for a in step_terms(4))
    batch = decode_batch(_torch(celeba_batch(B, 8, uint8=True)),
                         torch.bfloat16)
    noise = tuple(torch.from_numpy(a) for a in jax_noise(
        jax.random.key(4), 21, B))
    out = {}
    for bf16_loss in (False, True):
        pm = port_model(params, state, torch.bfloat16, bf16_loss=bf16_loss)
        pm.train()
        total, _ = multi_term_elbo(pm, batch, masks, lambdas, 1.0,
                                   train=True, noise=noise)
        pm.eval()
        ev, _ = multi_term_elbo(pm, batch, masks, lambdas, 1.0)
        out[bf16_loss] = (total.item(), ev.item())
    assert out[True][0] != out[False][0]
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-3)
    assert out[True][1] == out[False][1]


# --------------------------------------------------------------------------
# bf16 compute
# --------------------------------------------------------------------------

# Outputs that pass through a bf16 rounding (the conv stacks, the image
# head, the attribute decoder's bf16 input, weights and first product):
# each lies closer to JAX in bf16 than BF16_MARGIN times its gap to the
# port in f32 (rel_l1); the attribute encoders stay f32 and equal the
# port's f32 bit for bit. The eval loss is held at the f32 tolerance.
def test_bf16_between_its_readings(f32):
    _, params, state, pf = f32
    jm = JaxCeleba19(L, compute_dtype=jnp.bfloat16)
    pb = port_model(params, state, torch.bfloat16)
    batch = celeba_batch(B, 11)
    z = np.random.default_rng(10).normal(size=(B, L)).astype(np.float32)
    masks, lambdas = step_terms(12)
    mu, lv, _ = jm.encode(params, state, _jax(batch), None, False)
    rec, _ = jm.decode(params, state, jnp.asarray(z), None, False)
    _, terms = jax_make_eval_step(jm, masks, lambdas)(params, state,
                                                      _jax(batch))
    want = {"image mu": mu[0], "image logvar": lv[0], "attr mu": mu[1:],
            "attr logvar": lv[1:], "image logits": rec["image"],
            "attr logits": rec["attrs"], "eval per_term": terms}
    outs = []
    for m in (pb, pf):
        with torch.no_grad():
            p_mu, p_lv, _ = m.encode(_torch(batch))
            p_rec, _ = m.decode(torch.from_numpy(z))
        _, p_terms = make_eval_step(m, masks, lambdas, device="cpu")(
            _torch(batch))
        outs.append(dict(zip(want, (p_mu[0], p_lv[0], p_mu[1:], p_lv[1:],
                                    p_rec["image"], p_rec["attrs"],
                                    p_terms))))
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        got_b, got_f = outs[0][name].numpy(), outs[1][name].numpy()
        if name == "eval per_term":
            np.testing.assert_allclose(got_b, w, rtol=1e-4)
        elif name.startswith("attr") and "logits" not in name:
            np.testing.assert_array_equal(got_b, got_f, err_msg=name)
            np.testing.assert_allclose(got_b, w, **TOL, err_msg=name)
        else:
            to_jax, to_f32 = rel_l1(got_b, w), rel_l1(got_b, got_f)
            assert to_jax < BF16_MARGIN * to_f32, (name, to_jax, to_f32)


# --------------------------------------------------------------------------
# the CLIs on the CPU over tiny synthetic sets
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
    """The train CLI on 20 / 10 synthetic rows (--f32, --approx-m 1) for
    one epoch, --resume for a second, and one more with
    --fast-term-decode; (out dir, stdout)."""
    tmp = tmp_path_factory.mktemp("celeba19")
    out = str(tmp / "models")
    sets = {"train": synthetic_celeba(20, seed=0),
            "val": synthetic_celeba(10, seed=1),
            "test": synthetic_celeba(10, seed=2)}
    mp = pytest.MonkeyPatch()
    for mod in (c19_train, c19_sample, c19_loglike):
        mp.setattr(mod, "load_celeba", lambda data_dir, part, **kw:
                   sets[part])
    mp.setattr(torch.backends.cudnn, "allow_tf32",
               torch.backends.cudnn.allow_tf32)
    flags = CLI_FLAGS + ["--out-dir", out, "--data-dir", str(tmp)]
    resume = ["--resume", os.path.join(out, CKPT)]
    text = ""
    for extra in (["--epochs", "1"], ["--epochs", "2"] + resume,
                  ["--epochs", "3", "--fast-term-decode"] + resume):
        text += _run(c19_train.main, flags + extra)[1]
    yield out, text, tmp
    mp.undo()


def test_cli_trains_resumes_and_runs_fast(cli_run):
    out, text, _ = cli_run
    for e in (1, 2):
        assert f"resumed from {os.path.join(out, CKPT)} at epoch {e}" in text
    tests = [float(ln.split()[-1]) for ln in text.splitlines()
             if ln.startswith("====> Test Loss")]
    assert len(tests) == 3 and all(np.isfinite(tests))
    assert "Train Epoch: 3 [0/20" in text
    ckpt = torch.load(os.path.join(out, CKPT), map_location="cpu",
                      weights_only=True)
    assert ckpt["model"] == "celeba19" and ckpt["epoch"] == 3
    assert ckpt["mask_rng"]["bit_generator"] == "PCG64"


def test_cli_samples_conditioned_on_one_attribute(cli_run):
    out, _, tmp = cli_run
    for i, extra in enumerate(([], ["--condition-on-attrs", "Smiling"],
                               ["--condition-on-image", "Smiling"])):
        d = tmp / f"s{i}"
        res, _ = _run(c19_sample.main, [os.path.join(out, BEST), "--device",
                                        "cpu", "--n-samples", "10",
                                        "--out-dir", str(d), *extra])
        assert (d / "sample_image.png").read_bytes()[:8] == \
            b"\x89PNG\r\n\x1a\n"
        assert len((d / "sample_attrs.txt").read_text().splitlines()) == 10
        assert res["image"].shape == (10, 64, 64, 3)
        assert res["attrs"].shape == (10, 18)


def test_cli_loglike_joint(cli_run):
    out, _, _ = cli_run
    ll, text = _run(c19_loglike.main, [
        os.path.join(out, BEST), "--device", "cpu", "--target", "joint",
        "--n-samples", "3", "--batch-size", "4", "--max-examples", "6"])
    assert np.isfinite(ll) and ll < 0
    assert f"====> log p(joint) >= {ll:.4f}  (K=3, N=8)" in text


def test_cli_checkpoint_loads_into_jax(cli_run, tmp_path):
    """model_best.pth.tar read by the JAX package's importer gives the
    port's posteriors (f32, the golden tolerance), and Sampler serves
    it."""
    out, _, _ = cli_run
    src = os.path.join(out, BEST)
    path, meta = import_checkpoint("celeba19", src, str(tmp_path))
    assert meta["n_latents"] == L
    jm, params, state, _ = jax_load_model(path, JaxCeleba19)
    pm, _ = load_model_checkpoint(src, Celeba19MVAE, device="cpu")
    batch = celeba_batch(3, 14)
    for names in (("image",), ("attrs",), ("image", "attrs")):
        mu, lv = jm.infer(params, state, {k: jnp.asarray(batch[k])
                                          for k in names})
        with torch.no_grad():
            p_mu, p_lv = pm.infer({k: torch.from_numpy(batch[k])
                                   for k in names})
        np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), **TOL)
        np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), **TOL)
    sampler = Sampler.from_checkpoint(src, device="cpu")
    assert type(sampler.model) is Celeba19MVAE
    assert sampler.sample(2, {"attrs": batch["attrs"][:1]})["attrs"].shape \
        == (2, 18)
