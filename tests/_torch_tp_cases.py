"""The tensor-parallel steps' cases, shared by tests/test_torch_port_tp_
steps.py (dp1 x tp2) and tests/test_torch_port_tp_grid.py (dp2 x tp2): for
each family a window of K train steps of JAX's single-device
make_multi_train_step on the global batches, and the recipe of the same
window for the port's ranks (mvae_tpu_torch/tools/dp_check.py), from the
same weights (utils/weights.state_dict_from_jax), data and noise (JAX's
own draws, step by step as its scan splits the key)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from mvae_tpu.core import subsets as jax_subsets
from mvae_tpu.models.celeba import CelebaMVAE as JaxCeleba
from mvae_tpu.models.celeba19 import Celeba19MVAE as JaxCeleba19
from mvae_tpu.models.fashionmnist import FashionMnistMVAE as JaxFashion
from mvae_tpu.models.mnist import MnistMVAE as JaxMnist
from mvae_tpu.models.multimnist import MultiMnistMVAE as JaxMultiMnist
from mvae_tpu.models.vision import VisionMVAE as JaxVision
from mvae_tpu.train.loop import make_multi_train_step as jax_multi_step

import mvae_tpu_torch.experiments.vision.train as v_train
from mvae_tpu_torch.models import (
    Celeba19MVAE, CelebaMVAE, FashionMnistMVAE, MnistMVAE, MultiMnistMVAE,
    VisionMVAE)
from mvae_tpu_torch.tools import dp_check
from mvae_tpu_torch.utils.weights import state_dict_from_jax

from tests.test_torch_port_celeba19 import jax_noise as c19_noise
from tests.test_torch_port_dp import _jax_model, _port_sd
from tests.test_torch_port_modules import celeba_batch
from tests.test_torch_port_multimnist import jax_noise as mm_noise
from tests.test_torch_port_multimnist import mm_batch
from tests.test_torch_port_train import BN_FED_BIASES, _fed_by_noisy_bias
from tests.test_torch_port_train import jax_noise
from tests.test_torch_port_vision import jax_noise as vision_noise
from tests.test_torch_port_vision import vision_batch

L = 8
K = 2
LR = 1e-4
MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3
# f32 on both sides: the losses (JAX's own dp4 x tp2 test's rtol,
# tests/test_sharded_device_data.py)
LOSS_RTOL = 1e-5
# the gathered gradients against the single process's, relative
# Frobenius norm: the head's row layer sums its parts in another order,
# and the convs before a BN carry that (1e-4 of one process at most
# here); a gradient summed where it is sliced, or counted on the wrong
# group, is off by a factor of the group's size
GRAD_RTOL = 1e-3
# the state after K = 2 steps against JAX's, relative Frobenius norm: one
# process of the port reads up to 1.03e-3 here (CelebA's classifier.0 at
# B = 3 with random BN statistics, where 5 % of the elements' steps flip
# sign), so the ranks are held where one process is
STATE_RTOL = 2e-3


def _eps_only(key, b):
    return (np.asarray(jax.random.normal(jax.random.split(key, 3)[1],
                                         (3, b, L), jnp.float32)), None)


def _labels(n):
    def batch(b, seed):
        rng = np.random.default_rng(seed)
        images = rng.integers(0, 256, (b,) + n, dtype=np.uint8)
        return {"image": images,
                "text": rng.integers(0, 10, b).astype(np.int32)}
    return batch


def _mnist_batch(b, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, 784)).astype(np.float32),
            "text": rng.integers(0, 10, b).astype(np.int32)}


# family -> (JAX model, port model, port kwargs, batch(b, seed), noise(key,
# b), terms: "static" (MASKS, LAMBDAS), "vision" or "sampled")
FAMILIES = {
    "mnist": (JaxMnist, MnistMVAE, {}, _mnist_batch, _eps_only, "static"),
    "fashionmnist": (JaxFashion, FashionMnistMVAE, {}, _labels((28, 28, 1)),
                     _eps_only, "static"),
    "multimnist": (JaxMultiMnist, MultiMnistMVAE, {},
                   lambda b, s: mm_batch(b, s, uint8=True),
                   lambda key, b: mm_noise(key, 3, b), "static"),
    "celeba": (JaxCeleba, CelebaMVAE, {},
               lambda b, s: celeba_batch(b, s, uint8=True),
               lambda key, b: jax_noise(key, 3, b), "static"),
    "celeba19": (JaxCeleba19, Celeba19MVAE, {},
                 lambda b, s: celeba_batch(b, s, uint8=True),
                 lambda key, b: c19_noise(key, 21, b), "sampled"),
    "vision": (JaxVision, VisionMVAE, {},
               lambda b, s: vision_batch(b, s, uint8=True),
               lambda key, b: vision_noise(key, 7, b), "vision"),
    "vision-stacked": (JaxVision, VisionMVAE, {"stack_modalities": True},
                       lambda b, s: vision_batch(b, s, uint8=True),
                       lambda key, b: vision_noise(key, 7, b), "vision"),
}


def _export(name, params, state):
    family = name.split("-")[0]
    return state_dict_from_jax(family, jax.tree_util.tree_map(
        np.asarray, params), jax.tree_util.tree_map(np.asarray, state))


def case(name, b, *, seed=1, inject=True):
    """(the recipe of a window of K steps on global batches of b rows, a
    function that runs JAX's window: its losses (K,) and the state_dict
    after). inject=False: the recipe draws its own noise (the port's
    generator), and the function is None."""
    jcls, pcls, kw, make_batch, make_noise, terms = FAMILIES[name]
    jm, params, state = _jax_model(jcls, seed, name not in (
        "mnist", "fashionmnist"))
    batches = [make_batch(b, 11 + k) for k in range(K)]
    data = {n: np.concatenate([bt[n] for bt in batches])
            for n in batches[0]}
    betas = np.array([0.5, 1.0], np.float32)[:K]
    step_kw, extra = dict(lr=LR), {}
    jax_kw = {}
    if terms == "sampled":
        rng = np.random.default_rng(3)
        ms, ls = zip(*[jax_subsets.celeba19_step_terms(rng, 1, 18, 1.0, 10.0)
                       for _ in range(K)])
        extra = dict(masks=torch.tensor(np.stack(ms)).float(),
                     lambdas=torch.tensor(np.stack(ls)).float())
        step_kw.update(term_masks=None, term_lambdas=None)
        jax_kw = dict(dynamic_masks=True)
        masks, lambdas = None, None
    elif terms == "vision":
        masks, lambdas = v_train.TERM_MASKS, v_train.TERM_LAMBDAS
        step_kw.update(term_masks=masks, term_lambdas=lambdas,
                       recon_masks=v_train.RECON_MASKS)
        jax_kw = dict(recon_masks=v_train.RECON_MASKS)
    else:
        masks, lambdas = MASKS, LAMBDAS
        step_kw.update(term_masks=masks, term_lambdas=lambdas)
    key = jax.random.key(5)
    noise = None
    if inject:
        draws, r = [], key
        for _ in range(K):
            r, sub = jax.random.split(r)
            draws.append(make_noise(sub, b))
        noise = tuple(None if d[0] is None else
                      torch.from_numpy(np.stack([np.asarray(x) for x in d]))
                      for d in zip(*draws))
    rc = dp_check.recipe(
        pcls, (L,), kw, _port_sd(name.split("-")[0], params, state),
        {n: torch.from_numpy(v) for n, v in data.items()},
        torch.from_numpy(betas), step_kw=step_kw, noise=noise,
        windows=(1,) * K, name=name, seed=7, **extra)
    if not inject:
        return rc, None

    def run_jax():
        tx = optax.adam(LR)
        multi = jax_multi_step(jm, tx, masks, lambdas, **jax_kw)
        args = [jax.tree_util.tree_map(jnp.array, params), state,
                tx.init(params), key,
                {n: jnp.asarray(v)[None] for n, v in data.items()},
                jnp.arange(K * b).reshape(K, 1, b), jnp.asarray(betas)]
        if terms == "sampled":
            args += [jnp.asarray(extra["masks"].numpy()),
                     jnp.asarray(extra["lambdas"].numpy())]
        j_params, j_state, _, _, losses = multi(*args)
        return dict(losses=np.asarray(losses),
                    after=_export(name, j_params, j_state))
    return rc, run_jax


def noisy_keys(name, keys):
    """CelebA's BN-fed biases, whose gradients are rounding noise, and the
    running means that track them (tests/test_torch_port_train.py)."""
    if name != "celeba":
        return set()
    return set(BN_FED_BIASES) | {k for k in keys if _fed_by_noisy_bias(k)}


def held_to_jax(state, want, noisy):
    """The state after K Adam steps against JAX's, as tests/test_torch_
    port_dp.py holds one step: Adam moves an element by about lr a step
    whatever its gradient's size, so where a gradient is near 0 its
    rounding decides the sign, and a later step's statistics follow. No
    parameter element more than 2 * lr * K from JAX's; each tensor,
    running statistics too, within STATE_RTOL of JAX's in relative
    Frobenius norm; `noisy` tensors (BN-fed biases and the running means
    that track them) within 2 * lr * K alone."""
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue
        got, w = v.numpy(), want["after"][k]
        if "running" not in k or k in noisy:
            flips = np.abs(got - w).max()
            assert flips <= 2 * LR * K * (1 + 1e-3), (k, flips)
        if k not in noisy:
            gap = np.linalg.norm(got - w)
            assert gap <= STATE_RTOL * np.linalg.norm(w), (k, gap)


def grads_held(got, want, noisy):
    """Every gradient within GRAD_RTOL of the single process's in relative
    Frobenius norm; the noisy ones, 0 in exact arithmetic and rounding
    noise of either side's sums, within 1e-3 absolute."""
    assert set(got) == set(want)
    for k, w in want.items():
        gap = float((got[k] - w).norm())
        if k in noisy:
            assert gap < 1e-3, (k, gap)
        else:
            assert gap <= GRAD_RTOL * float(w.norm()), (k, gap)


def check_window(name, outs, single, want, dp_world):
    """The ranks' outcomes of a case against JAX (the mean of the dp
    indices' losses at every step at LOSS_RTOL, the parameters and
    running statistics after K steps) and against the port's single
    process (the gathered gradients of step 1: after an Adam step the
    near-0 gradients' signs part the two, as they part JAX and one
    process); every rank ends with the same state."""
    tp_world = len(outs) // dp_world
    for k in range(K):
        loss = sum(float(o["windows"][k]["losses"][0])
                   for o in outs[::tp_world]) / dp_world
        np.testing.assert_allclose(loss, want["losses"][k], rtol=LOSS_RTOL)
    first = single["windows"][0]["grads"]
    for o in outs:
        grads_held(o["windows"][0]["grads"], first, noisy_keys(name, first))
    last = [o["windows"][-1] for o in outs]
    state = dict(last[0]["params"], **last[0]["running"])
    held_to_jax(state, want, noisy_keys(name, state))
    for w in last[1:]:
        for part in ("params", "running"):
            for k, v in w[part].items():
                assert torch.equal(v, last[0][part][k]), (name, k)


def spawn(world, cases):
    """Every case's recipe replayed on `world` spawned gloo ranks (one
    spawn, on a thread), and meanwhile in this process alone on the whole
    batches and JAX's windows (one run a function: the vision loop and
    stack share theirs): [(the ranks' outcomes, the single process's,
    JAX's or None)]."""
    recipes = [rc for rc, _ in cases]
    got = {}

    def ranks():
        try:
            got["outs"] = dp_check.spawn_ranks(
                world, dp_check.replay_all, recipes, device="cpu",
                timeout_s=300)
        except Exception as e:          # raised in the test's thread
            got["error"] = e
    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        singles = [dp_check.replay(rc, torch.device("cpu"))
                   for rc in recipes]
        wants, shared = [], {}
        for rc, fn in cases:
            key = rc["name"].split("-")[0]
            if fn is not None and key not in shared:
                shared[key] = fn()
            wants.append(None if fn is None else shared[key])
    finally:
        thread.join()
    if "error" in got:
        raise got["error"]
    return [([o[i] for o in got["outs"]], singles[i], wants[i])
            for i in range(len(cases))]
