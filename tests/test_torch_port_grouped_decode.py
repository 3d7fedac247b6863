"""The train step's grouped decode (mvae_tpu_torch/core/engine.py:
decode_plan, the JAX package's engine.py:_decode_grouped) on the CPU, at
small widths in f32:

  - each family's port train step with the support it derives from its
    static masks (celeba19: the CLI's celeba19_recon_support) against the
    JAX package's make_train_step, which derives the same support and
    takes its own grouped path, from the same weights, batch and JAX
    noise: the loss, the per-term ELBOs, every parameter gradient (read
    off JAX's step through an optimizer whose state keeps the gradient)
    and every BN running statistic;
  - the same step against the port's step with an all-ones support (the
    one-batch decode);
  - the plans: which decoder groups each family's terms run with
    autograd, forward alone (BN statistics) or not at all;
  - FlopCounterMode's count of the step: flops_per_step, plus the
    forwards of the BN'd decoders' dead terms, and nothing for the
    stateless ones;
  - celeba19's decode_group_key and decode_term_operands against JAX's;
  - the grouped step on two gloo ranks (CelebA data-parallel, celeba19
    expert-parallel) against one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mvae_tpu.core import subsets as jax_subsets
from mvae_tpu.models.celeba import CelebaMVAE as JaxCeleba
from mvae_tpu.models.celeba19 import Celeba19MVAE as JaxCeleba19
from mvae_tpu.models.fashionmnist import FashionMnistMVAE as JaxFashion
from mvae_tpu.models.mnist import MnistMVAE as JaxMnist
from mvae_tpu.models.multimnist import MultiMnistMVAE as JaxMultiMnist
from mvae_tpu.train.loop import _static_support as jax_static_support
from mvae_tpu.train.loop import make_train_step as jax_make_train_step

from mvae_tpu_torch.core import subsets
from mvae_tpu_torch.core.engine import decode_plan, static_support
from mvae_tpu_torch.models import (
    Celeba19MVAE, CelebaMVAE, FashionMnistMVAE, MnistMVAE, MultiMnistMVAE)
from mvae_tpu_torch.tools import dp_check, measure
from mvae_tpu_torch.train.loop import make_train_step
from mvae_tpu_torch.utils.weights import state_dict_from_jax

from tests._torch_tp_cases import _eps_only, _labels
from tests.test_torch_port_celeba19 import jax_noise as c19_noise
from tests.test_torch_port_dp import _jax_model, _mnist_batch, _port_sd
from tests.test_torch_port_modules import celeba_batch
from tests.test_torch_port_multimnist import jax_noise as mm_noise
from tests.test_torch_port_multimnist import mm_batch
from tests.test_torch_port_train import BN_FED_BIASES, _fed_by_noisy_bias

L = 8
B = 4
LR = 1e-4
MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3
# f32: the whole multi-term ELBO's tolerance (the golden tests'); the
# gathered experts of celeba19 sum their products in another grouping
# (tests/test_celeba19.py:181-210 holds JAX's own gather so)
RTOL = {"celeba19": 5e-4}
# the gradients of the BN-fed biases are 0 in exact arithmetic: both sides
# return rounding noise (tests/test_torch_port_train.py)
NOISE_ATOL = 1e-4

# family -> (JAX model, port model, batch(b, seed), noise(key, b) as the
# port takes it, sampled terms)
FAMILIES = {
    "mnist": (JaxMnist, MnistMVAE, _mnist_batch, _eps_only, False),
    "fashionmnist": (JaxFashion, FashionMnistMVAE, _labels((28, 28, 1)),
                     _eps_only, False),
    "multimnist": (JaxMultiMnist, MultiMnistMVAE,
                   lambda b, s: mm_batch(b, s, uint8=True),
                   lambda key, b: mm_noise(key, 3, b), False),
    "celeba": (JaxCeleba, CelebaMVAE,
               lambda b, s: celeba_batch(b, s, uint8=True),
               lambda key, b: _celeba_noise(key, b), False),
    "celeba19": (JaxCeleba19, Celeba19MVAE,
                 lambda b, s: celeba_batch(b, s, uint8=True),
                 lambda key, b: c19_noise(key, 21, b), True),
}


def _celeba_noise(key, b):
    from tests.test_torch_port_train import jax_noise
    return jax_noise(key, 3, b)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _terms(family):
    """(masks, lambdas, support, dynamic) of the family's CLI step:
    celeba19's 21 terms (one sampled) with the CLI's support."""
    if family == "celeba19":
        masks, lambdas = subsets.celeba19_step_terms(
            np.random.default_rng(3), 1, 18, 1.0, 10.0)
        return masks, lambdas, subsets.celeba19_recon_support(1), True
    return (np.asarray(MASKS, np.float32), np.asarray(LAMBDAS, np.float32),
            None, False)


def _keeping_gradients():
    """An optax transformation that leaves the parameters where they are
    and keeps the step's gradients as its state: JAX's make_train_step
    then returns them exactly."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def _port_step(family, params, state, batch, noise, support, **kw):
    """The port's make_train_step from JAX's weights: (loss, per_term,
    gradients, running statistics, FlopCounterMode's count, the step's
    plan)."""
    _, pcls, _, _, _ = FAMILIES[family]
    masks, lambdas, _, dynamic = _terms(family)
    model = pcls(L, device="cpu")
    model.load_state_dict(_port_sd(family, params, state), strict=True)
    step = make_train_step(
        model, None if dynamic else masks, None if dynamic else lambdas,
        lr=LR, device="cpu", generator=torch.Generator().manual_seed(0),
        recon_support=support, **kw)
    terms = {} if not dynamic else dict(masks=torch.tensor(masks),
                                        lambdas=torch.tensor(lambdas))
    with FlopCounterMode(display=False) as counter:
        loss, per_term = step({k: torch.from_numpy(v)
                               for k, v in batch.items()}, 0.5,
                              noise, **terms)
    return dict(
        loss=float(loss), per_term=per_term.numpy(),
        grads={k: p.grad.numpy().copy() for k, p in model.named_parameters()
               if p.grad is not None},
        running={k: v.numpy().copy() for k, v in model.state_dict().items()
                 if "running" in k},
        flops=counter.get_total_flops(), plan=step.plan, model=model)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def steps(request):
    """family -> JAX's make_train_step (its grouped path), the port's step
    with the derived support, and the port's step with all ones."""
    family = request.param
    jcls, _, make_batch, make_noise, _ = FAMILIES[family]
    masks, lambdas, support, dynamic = _terms(family)
    jm, params, state = _jax_model(jcls, 1, family not in (
        "mnist", "fashionmnist"))
    batch = make_batch(B, 11)
    key = jax.random.key(5)
    tx = _keeping_gradients()
    if dynamic:
        step = jax_make_train_step(
            jm, tx, None, None, dynamic_masks=True,
            recon_support=jax_subsets.celeba19_recon_support(1, 18))
        extra = (jnp.asarray(masks), jnp.asarray(lambdas))
    else:
        step = jax_make_train_step(jm, tx, masks, lambdas)
        extra = ()
    _, j_state, grads, _, loss, per_term = step(
        jax.tree_util.tree_map(jnp.array, params), state, tx.init(params),
        key, {k: jnp.asarray(v) for k, v in batch.items()}, 0.5, *extra)
    want = dict(
        loss=float(loss), per_term=np.asarray(per_term),
        grads=state_dict_from_jax(family, jax.tree_util.tree_map(
            np.asarray, grads), state),
        running={k: v for k, v in state_dict_from_jax(
            family, params, jax.tree_util.tree_map(np.asarray, j_state))
            .items() if "running" in k})
    _, sub = jax.random.split(key)
    noise = tuple(None if n is None else torch.from_numpy(np.array(n))
                  for n in make_noise(sub, B))
    grouped = _port_step(family, params, state, batch, noise, support)
    ones = _port_step(family, params, state, batch, noise,
                      np.ones_like(masks))
    names = dict(grouped["model"].named_parameters())
    want["grads"] = {k: v for k, v in want["grads"].items() if k in names}
    return family, want, grouped, ones


def _noisy(family, keys):
    if family != "celeba":
        return set()
    return set(BN_FED_BIASES) | {k for k in keys if _fed_by_noisy_bias(k)}


def _held(got, want, rtol, noisy):
    """loss and per-term ELBOs at rtol; each gradient within rtol of the
    other's in relative Frobenius norm (the BN-fed biases, rounding noise,
    within NOISE_ATOL); each running statistic at rtol."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=rtol)
    np.testing.assert_allclose(got["per_term"], want["per_term"], rtol=rtol)
    assert set(got["grads"]) == set(want["grads"])
    for k, w in want["grads"].items():
        gap = float(np.linalg.norm(got["grads"][k] - w))
        if k in noisy:
            assert gap < NOISE_ATOL, (k, gap)
        else:
            assert gap <= rtol * float(np.linalg.norm(w)), (k, gap)
    assert set(got["running"]) == set(want["running"])
    for k, w in want["running"].items():
        if k.endswith("num_batches_tracked"):
            continue
        if k in noisy:
            np.testing.assert_allclose(got["running"][k], w, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got["running"][k], w, rtol=rtol,
                                       atol=1e-6, err_msg=k)


def test_grouped_step_matches_jax_make_train_step(steps):
    """The port's grouped step against JAX's make_train_step (its grouped
    path) at rtol 1e-4 (celeba19 5e-4): loss, per-term ELBOs, gradients,
    running statistics."""
    family, want, grouped, _ = steps
    assert grouped["plan"] is not None
    _held(grouped, want, RTOL.get(family, 1e-4),
          _noisy(family, want["grads"]))


def test_grouped_step_matches_the_one_batch_step(steps):
    """The all-ones support takes the one-batch decode, and gives the
    grouped step's values: a dead term's gradient is 0 in both."""
    family, _, grouped, ones = steps
    assert ones["plan"] is None
    _held(grouped, ones, RTOL.get(family, 1e-4),
          _noisy(family, ones["grads"]))


# the decoder groups' calls of each family's step: (group, terms, with
# autograd); a term of no call runs nothing of that group
PLANS = {
    "mnist": [("image", (0, 1), True), ("text", (0, 2), True)],
    "fashionmnist": [("image", (0, 1), True), ("text", (0, 2), True)],
    "multimnist": [("image", (0, 1), True), ("image", (2,), False),
                   ("text", (0, 2), True)],
    "celeba": [("image", (0, 1), True), ("image", (2,), False),
               ("attrs", (0, 2), True), ("attrs", (1,), False)],
    "celeba19": [("image", (0, 1, 20), True),
                 ("image", tuple(range(2, 20)), False),
                 ("attrs", (0, 20), True),
                 ("attrs", tuple(range(2, 20)), True)],
}


def _calls(plan):
    return [(g.name, c.index, c.grad) for g in plan for c in g.calls]


def test_plans(steps):
    """Live groups with autograd, BN'd dead groups forward alone, stateless
    dead groups (mnist's and fashionmnist's MLPs, MultiMNIST's GRU,
    celeba19's experts for its image-only term) not at all; celeba19's
    single-attribute terms gather their one expert each."""
    family, _, grouped, _ = steps
    plan = grouped["plan"]
    assert _calls(plan) == PLANS[family]
    if family == "celeba19":
        gathered = plan[1].calls[1].operand
        assert gathered.index.tolist() == [[i] for i in range(18)]
        assert gathered.experts == tuple(range(18))
        assert gathered.rows is None
        assert plan[1].calls[0].operand is None


def test_fast_term_decode_skips_the_dead_image():
    """--fast-term-decode: celeba19's single-attribute terms run no image
    decode at all; the other calls are the default plan's."""
    model = Celeba19MVAE(L, device="cpu")
    sup = subsets.celeba19_recon_support(1)
    fast = decode_plan(model, sup, fast_skip_decode=True)
    assert _calls(fast) == [c for c in PLANS["celeba19"]
                            if c[:2] != ("image", tuple(range(2, 20)))]
    assert decode_plan(model, np.ones_like(sup)) is None


def test_counter_runs_only_the_stateful_dead_forwards(steps):
    """FlopCounterMode's count of the grouped step (less the PoE plain
    version's products) is flops_per_step plus the forward of each BN'd
    decoder for the terms that never train it, and nothing of the
    stateless ones; celeba19's sampled term, whose support holds every
    modality, also runs those its weights leave at 0, with their
    backward."""
    family, _, grouped, ones = steps
    masks, lambdas, support, _ = _terms(family)
    model = grouped["model"]
    t, m = masks.shape
    poe = 6 * 2 * t * m * B * L
    want = measure.count_step(model, masks, lambdas, B,
                              recon_support=support)
    fwd = want.forward
    if family in ("mnist", "fashionmnist"):
        dead = 0
    elif family == "multimnist":
        dead = fwd["image"]
    elif family == "celeba":
        dead = fwd["image"] + fwd["attrs"]
    else:
        off = (masks[20] * lambdas[20]) == 0
        dead = 18 * fwd["image"] + sum(
            want.decode[n] for n, o in zip(model.modalities, off) if o)
    assert grouped["flops"] - poe == want.needed + want.dead
    assert want.dead == dead
    one = measure.count_step(model, masks, lambdas, B,
                             recon_support=np.ones_like(masks))
    assert ones["flops"] - poe == one.needed + one.dead
    assert one.dead > want.dead


def test_celeba19_group_keys_and_operands_are_jax():
    """decode_group_key and decode_term_operands' index on JAX's own case
    (tests/test_celeba19.py:199-203) and on the CLI's support."""
    jm = JaxCeleba19(6)
    pm = Celeba19MVAE(6, device="cpu")
    masks = np.zeros((5, 19), np.float32)
    masks[0] = 1.0
    masks[1, 0] = 1.0
    masks[2, 3] = 1.0
    masks[3, 11] = 1.0
    masks[4, [2, 5, 9]] = 1.0
    sup = subsets.celeba19_recon_support(2)
    for row in list(masks) + list(sup):
        assert pm.decode_group_key(tuple(row)) == jm.decode_group_key(
            tuple(row))
        assert pm.stop_grad_groups(tuple(row)) == jm.stop_grad_groups(
            tuple(row))
    for rows in (masks[[4]], masks[[2, 3]], sup[2:20]):
        np.testing.assert_array_equal(
            pm.decode_term_operands(rows).index,
            np.asarray(jm.decode_term_operands(rows)))


@pytest.mark.parametrize("family", ["mnist", "celeba"])
def test_static_support_is_jax(family):
    masks, lambdas, _, _ = _terms(family)
    lambdas = lambdas.copy()
    lambdas[1, 0] = 0.0
    np.testing.assert_array_equal(static_support(masks, lambdas),
                                  jax_static_support(masks, lambdas, None))


# --------------------------------------------------------------------------
# two gloo ranks
# --------------------------------------------------------------------------

def _recipe(family, b):
    """A step of the family's grouped train step at global batch b, from
    random weights with random BN statistics, with JAX's noise."""
    jcls, pcls, make_batch, make_noise, dynamic = FAMILIES[family]
    masks, lambdas, support, _ = _terms(family)
    _, params, state = _jax_model(jcls, 2, True)
    batch = make_batch(b, 13)
    noise = tuple(None if n is None else torch.from_numpy(np.array(n))[None]
                  for n in make_noise(jax.random.key(9), b))
    step_kw = dict(term_masks=None if dynamic else MASKS,
                   term_lambdas=None if dynamic else LAMBDAS, lr=LR,
                   recon_support=support)
    terms = (dict(masks=torch.tensor(masks)[None],
                  lambdas=torch.tensor(lambdas)[None]) if dynamic else {})
    return dp_check.recipe(
        pcls, (L,), {}, _port_sd(family, params, state),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.tensor([0.5]), step_kw=step_kw, noise=noise, name=family,
        **terms)


@pytest.fixture(scope="module")
def two_ranks():
    """CelebA at B = 4 on dp2 (the dead groups' BN forwards all-reduce
    their statistics over the dp group and count both ranks' rows), and
    celeba19 at B = 3 on dp1 x tp2 (9 experts a rank: each rank decodes
    the gathered experts it holds); both ranks and one process."""
    recipes = [_recipe("celeba", 4), _recipe("celeba19", 3)]
    outs = dp_check.spawn_ranks(2, dp_check.replay_all, recipes,
                                device="cpu", timeout_s=240)
    return {rc["name"]: ([o[i] for o in outs],
                         dp_check.replay(rc, torch.device("cpu")))
            for i, rc in enumerate(recipes)}


@pytest.mark.parametrize("family", ["celeba", "celeba19"])
def test_grouped_step_on_two_ranks_is_one_process(two_ranks, family):
    """The ranks' loss (dp: their mean) is one process's at rtol 1e-5,
    every gradient and running statistic within 1e-4 of its (the BN-fed
    biases' rounding noise within NOISE_ATOL), the ranks' parameters
    equal."""
    got, single = two_ranks[family]
    want = single["windows"][0]
    losses = [float(o["windows"][0]["losses"][0]) for o in got]
    if family == "celeba":
        loss = sum(losses) / 2
    else:
        assert losses[0] == losses[1]
        loss = losses[0]
    np.testing.assert_allclose(loss, float(want["losses"][0]), rtol=1e-5)
    noisy = _noisy(family, want["grads"])
    for o in got:
        w = o["windows"][0]
        for k, g in want["grads"].items():
            gap = float((w["grads"][k] - g).norm())
            if k in noisy:
                assert gap < NOISE_ATOL, (k, gap)
            else:
                assert gap <= 1e-4 * float(g.norm()), (k, gap)
        for k, r in want["running"].items():
            tol = dict(atol=1e-6) if k in noisy else dict(rtol=1e-4,
                                                          atol=1e-6)
            torch.testing.assert_close(w["running"][k], r, **tol)
    for k, v in got[0]["windows"][0]["params"].items():
        assert torch.equal(v, got[1]["windows"][0]["params"][k]), k
    if family == "celeba19":
        assert got[0]["tp_collectives"] > 0
