"""Data parallelism of the port on the CPU: 2 gloo ranks, spawned
(mvae_tpu_torch/tools/dp_check.py:spawn_ranks, a rendezvous file of its
own and a time limit on every wait), against one process and against the
JAX package's single-device train step.

  - the BN ops with a process group (ops/bn.py, nn/norm.py) on two halves
    of a batch against one process on the whole: y, mean, var, dx, and the
    scale's and bias's gradients, whose ranks' shares add up to the
    whole's (trap a), Moments.n and the running statistics committed from
    it (trap b), and the fused route's differentiable all-reduce of the
    conv's sums (trap c);
  - the dp train step (train/loop.py, dp=...) at N = 2 on MNIST, CelebA,
    MultiMNIST (dropout in the encoder and the text decoder) and celeba19
    (T = 21 sampled terms) against JAX's make_train_step on the global
    batch with the same noise and weights (utils/weights.state_dict_from_
    jax): the loss, the parameters after one Adam step and the running
    statistics;
  - the per-replica step (parallel/data_parallel.py) against JAX's step
    on each shard, its gradients and new states averaged.

Every rank's side runs in f32 on the plain versions of the kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvae_tpu.core import subsets as jax_subsets
from mvae_tpu.models.celeba import CelebaMVAE as JaxCeleba
from mvae_tpu.models.celeba19 import Celeba19MVAE as JaxCeleba19
from mvae_tpu.models.mnist import MnistMVAE as JaxMnist
from mvae_tpu.models.multimnist import MultiMnistMVAE as JaxMultiMnist
from mvae_tpu.train.loop import make_train_step as jax_make_train_step

from mvae_tpu_torch.models import (
    Celeba19MVAE, CelebaMVAE, MnistMVAE, MultiMnistMVAE)
from mvae_tpu_torch.tools import dp_check
from mvae_tpu_torch.utils.weights import state_dict_from_jax

from tests import _torch_dp_ranks as ranks
from tests.test_torch_port_celeba19 import jax_noise as c19_noise
from tests.test_torch_port_modules import _randomize_bn, celeba_batch
from tests.test_torch_port_multimnist import jax_noise as mm_noise
from tests.test_torch_port_multimnist import mm_batch
from tests.test_torch_port_train import BN_FED_BIASES, _fed_by_noisy_bias
from tests.test_torch_port_train import _jax_elbo, jax_noise

WORLD = 2
L = 8
MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3
# f32, one op on two halves against the whole: the sums over the rows
# taken in two parts and added
BN_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """This process's side on one intra-op thread, restored after (see
    tests/test_torch_port_families.py); the ranks pin one themselves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# the BN ops on two halves
# --------------------------------------------------------------------------

def _bn_case(kind, groups, ndim, seed):
    rng = np.random.default_rng(seed)
    c = 8 if kind == "stacked" else 6
    rows = groups * 8
    shape = (rows, c) + ((3, 4) if ndim == 4 else ())
    x = rng.normal(0.5, 1.5, shape).astype(np.float32)
    g = rng.normal(0.0, 1.0, shape).astype(np.float32)
    return dict(kind=kind, groups=groups, x=torch.from_numpy(x),
                g=torch.from_numpy(g),
                scale=torch.from_numpy(rng.normal(1.0, 0.2, c)
                                       .astype(np.float32)),
                bias=torch.from_numpy(rng.normal(0.0, 0.2, c)
                                      .astype(np.float32)))


BN_CASES = {f"{kind}-G{g}-{nd}d": (kind, g, nd)
            for kind in ("op", "module", "stacked") for g in (1, 3)
            for nd in (2, 4)}
BN_CASES["moments-G1-4d"] = ("moments", 1, 4)


@pytest.fixture(scope="module")
def bn_runs():
    """Every case on two ranks (one spawn) and in this process whole."""
    cases = [_bn_case(*v, seed=i) for i, v in enumerate(BN_CASES.values())]
    outs = dp_check.spawn_ranks(WORLD, ranks.bn_cases, cases, device="cpu",
                                timeout_s=120)
    whole = [ranks.bn_case(c, 0, 1, None) for c in cases]
    return {name: (cases[i], whole[i], [o[i] for o in outs])
            for i, name in enumerate(BN_CASES)}


def _joined(parts, groups):
    """The ranks' rows back in the whole batch's order, group by group."""
    return torch.cat([p.reshape((groups, -1) + p.shape[1:]) for p in parts],
                     1).reshape((-1,) + parts[0].shape[1:])


@pytest.mark.parametrize("name", sorted(BN_CASES))
def test_bn_on_two_halves_matches_the_whole(bn_runs, name):
    """y and dx on the ranks' rows are the whole's rows; mean, var (and
    Moments.n: the count over both ranks) on every rank are the whole's;
    the ranks' gradients of scale and bias add up to the whole's, so the
    train step's average gives the gradient of the mean loss; the running
    statistics each rank commits are the whole's."""
    case, whole, got = bn_runs[name]
    g = case["groups"]
    for key in ("y", "dx"):
        torch.testing.assert_close(_joined([o[key] for o in got], g),
                                   whole[key], **BN_TOL)
    for o in got:
        for key in ("mean", "var", "running"):
            if key in whole:
                torch.testing.assert_close(o[key], whole[key], **BN_TOL)
        if "n" in whole:
            assert torch.equal(o["n"], whole["n"])
    for key in ("dscale", "dbias"):
        torch.testing.assert_close(sum(o[key] for o in got), whole[key],
                                   **BN_TOL)
        assert not torch.allclose(got[0][key], whole[key], rtol=1e-2)


# --------------------------------------------------------------------------
# the dp train step against JAX's single-device step
# --------------------------------------------------------------------------

def _mnist_batch(b, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, 784)).astype(np.float32),
            "text": rng.integers(0, 10, b).astype(np.int32)}


def _jax_model(cls, seed, randomize):
    jm = cls(L)
    params, state = jm.init(jax.random.key(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    if randomize:
        rng = np.random.default_rng(seed)
        params, state = _randomize_bn(params, rng), _randomize_bn(state, rng)
    return jm, params, state


def _port_sd(family, params, state):
    return {k: torch.tensor(v) for k, v in
            state_dict_from_jax(family, params, state).items()}


# family -> (JAX model, port model, batch(b, seed), noise(sub, b) as the
# port takes it, lr, global batch, sampled terms)
FAMILIES = {
    "mnist": (JaxMnist, MnistMVAE, _mnist_batch,
              lambda key, b: (np.asarray(jax.random.normal(
                  jax.random.split(key, 3)[1], (3, b, L), jnp.float32)),
                  None), 1e-4, 8, False),
    "celeba": (JaxCeleba, CelebaMVAE,
               lambda b, s: celeba_batch(b, s, uint8=True),
               lambda key, b: jax_noise(key, 3, b), 1e-4, 8, False),
    "multimnist": (JaxMultiMnist, MultiMnistMVAE,
                   lambda b, s: mm_batch(b, s, uint8=True),
                   lambda key, b: mm_noise(key, 3, b), 1e-4, 4, False),
    "celeba19": (JaxCeleba19, Celeba19MVAE,
                 lambda b, s: celeba_batch(b, s, uint8=True),
                 lambda key, b: c19_noise(key, 21, b), 1e-4, 4, True),
}


def _family_recipe(family):
    """JAX's make_train_step on the global batch, and the recipe of the
    same step for the ranks."""
    jcls, pcls, make_batch, make_noise, lr, b, sampled = FAMILIES[family]
    jm, params, state = _jax_model(jcls, 1, family != "mnist")
    batch = make_batch(b, 11)
    key = jax.random.key(5)
    tx = optax.adam(lr)
    if sampled:
        masks, lambdas = jax_subsets.celeba19_step_terms(
            np.random.default_rng(3), 1, 18, 1.0, 10.0)
        step = jax_make_train_step(jm, tx, None, None, dynamic_masks=True)
        extra = (jnp.asarray(masks), jnp.asarray(lambdas))
    else:
        masks, lambdas = MASKS, LAMBDAS
        step = jax_make_train_step(jm, tx, MASKS, LAMBDAS)
        extra = ()
    j_params, j_state, _, _, loss, _ = step(
        jax.tree_util.tree_map(jnp.array, params), state, tx.init(params),
        key, {k: jnp.asarray(v) for k, v in batch.items()}, 0.5, *extra)
    _, sub = jax.random.split(key)
    noise = tuple(None if n is None else torch.from_numpy(np.array(n))[None]
                  for n in make_noise(sub, b))
    step_kw = dict(term_masks=None if sampled else MASKS,
                   term_lambdas=None if sampled else LAMBDAS, lr=lr)
    terms = (dict(masks=torch.tensor(masks)[None],
                  lambdas=torch.tensor(lambdas)[None]) if sampled else {})
    rc = dp_check.recipe(
        pcls, (L,), {}, _port_sd(family, params, state),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.tensor([0.5]), step_kw=step_kw, noise=noise, name=family,
        **terms)
    want = dict(loss=float(loss), before=state_dict_from_jax(
        family, params, state), after=state_dict_from_jax(
        family, jax.tree_util.tree_map(np.asarray, j_params),
        jax.tree_util.tree_map(np.asarray, j_state)), lr=lr)
    return rc, want


@pytest.fixture(scope="module")
def dp_steps():
    """family -> (JAX's step, both ranks' outcomes, the port's single
    process on the global batch); the four families' recipes on one spawn
    of two ranks."""
    made = {f: _family_recipe(f) for f in FAMILIES}
    outs = dp_check.spawn_ranks(WORLD, dp_check.replay_all,
                                [rc for rc, _ in made.values()],
                                device="cpu", timeout_s=240)
    return {f: (want, [o[i] for o in outs],
                dp_check.replay(rc, torch.device("cpu")))
            for i, (f, (rc, want)) in enumerate(made.items())}


def _held_to_jax(state, want, lr, noisy=()):
    """Parameters and running statistics after one Adam step from the same
    start: each tensor within 1e-4 of JAX's in relative Frobenius norm,
    and no parameter element more than 2 * lr from JAX's (Adam's first
    step moves an element by lr whatever its gradient's size, so where a
    gradient element is near 0 its rounding decides the sign: the
    port's own single-device step differs from JAX's so too); `noisy`:
    tensors whose gradient is rounding noise in exact arithmetic (BN-fed
    biases) and the running means that track them, held within 2 * lr."""
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue
        got, w = v.numpy(), want["after"][k]
        flips = np.abs(got - w).max()
        if "running" not in k or k in noisy:
            assert flips <= 2 * lr * (1 + 1e-3), (k, flips)
        if k not in noisy:
            gap = np.linalg.norm(got - w)
            assert gap <= 1e-4 * np.linalg.norm(w), (k, gap)


def _grads_held(got, want, noisy):
    """Every gradient within 1e-4 of the single process's in relative
    Frobenius norm; the BN-fed biases', rounding noise, within 1e-4."""
    for k, w in want.items():
        gap = float((got[k] - w).norm())
        if k in noisy:
            assert gap < 1e-4, (k, gap)
        else:
            assert gap <= 1e-4 * float(w.norm()), (k, gap)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dp_step_matches_jax_single_device(dp_steps, family):
    """The ranks' mean loss is JAX's loss on the global batch (rtol 1e-4);
    both ranks hold the same parameters and running statistics, JAX's
    after its step (_held_to_jax). One Adam step from a zero state is
    blind to a gradient's scale, so the gradients after the all-reduce
    are held to the port's single process on the global batch too
    (_grads_held): a rank's share of a BN's scale gradient off by the
    world size (trap a) fails there."""
    want, got, single = dp_steps[family]
    loss = sum(float(o["windows"][0]["losses"][0]) for o in got) / WORLD
    np.testing.assert_allclose(loss, want["loss"], rtol=1e-4)
    noisy = set(BN_FED_BIASES) if family == "celeba" else set()
    for o in got:
        w = o["windows"][0]
        state = dict(w["params"], **w["running"])
        _held_to_jax(state, want, want["lr"], noisy | {
            k for k in state if family == "celeba" and _fed_by_noisy_bias(k)})
        _grads_held(w["grads"], single["windows"][0]["grads"], noisy)
    for k, v in got[0]["windows"][0]["params"].items():
        assert torch.equal(v, got[1]["windows"][0]["params"][k]), k
    if family == "celeba":        # 11 BN layers: one all-reduce a pass;
        # the grouped decode's dead terms run the decoders' 6 BN layers
        # once more, forward alone (their statistics are all-reduced too)
        assert got[0]["all_reduces"] == 2 * got[0]["n_bn"] + 6 + 1 == 29


# --------------------------------------------------------------------------
# the per-replica step against JAX's step on each shard
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def replica_step():
    """CelebA at B = 8, 4 a rank: JAX's gradients and new states on each
    shard with its own noise, averaged, then one Adam step; the ranks'
    per-replica step from the same weights, each with its shard's noise."""
    lr = 1e-4
    jm, params, state = _jax_model(JaxCeleba, 2, True)
    batch = celeba_batch(8, 21, uint8=True)
    keys = [jax.random.key(30 + r) for r in range(WORLD)]
    shards = [{k: v[4 * r:4 * (r + 1)] for k, v in batch.items()}
              for r in range(WORLD)]
    runs = [_jax_elbo(jm, params, state, s, k) for s, k in zip(shards, keys)]
    grads = jax.tree_util.tree_map(lambda *g: sum(g) / WORLD,
                                   *[r[2] for r in runs])
    tx = optax.adam(lr)
    updates, _ = tx.update(grads, tx.init(params), params)
    j_params = optax.apply_updates(params, updates)
    j_state = jax.tree_util.tree_map(lambda *s: sum(s) / WORLD,
                                     *[r[3] for r in runs])
    noise = [jax_noise(k, 3, 4) for k in keys]
    rc = dp_check.recipe(
        CelebaMVAE, (L,), {}, _port_sd("celeba", params, state),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.tensor([0.7]), step_kw=dict(
            term_masks=MASKS, term_lambdas=LAMBDAS, lr=lr),
        noise=(torch.from_numpy(np.concatenate([n[0] for n in noise], 1))[
            None], torch.from_numpy(np.concatenate([n[1] for n in noise]))[
            None]), sync_bn=False, name="replica")
    outs = dp_check.spawn_ranks(WORLD, dp_check.replay_all, [rc],
                                device="cpu", timeout_s=120)
    want = dict(loss=sum(r[0] for r in runs) / WORLD, lr=lr,
                before=state_dict_from_jax("celeba", params, state),
                after=state_dict_from_jax(
                    "celeba", jax.tree_util.tree_map(np.asarray, j_params),
                    jax.tree_util.tree_map(np.asarray, j_state)))
    return want, [o[0] for o in outs]


def test_replica_step_averages_jax_shard_steps(replica_step):
    """Each rank returns the mean of the shards' losses; both hold the
    Adam step on the mean of the shards' gradients and the mean of the
    shards' running statistics (_held_to_jax); the BNs' statistics were
    each rank's own, so no BN all-reduce ran: one for the gradients, one
    for the running statistics, one for the loss."""
    want, got = replica_step
    for o in got:
        w = o["windows"][0]
        np.testing.assert_allclose(float(w["losses"][0]), want["loss"],
                                   rtol=1e-4)
        state = dict(w["params"], **w["running"])
        noisy = set(BN_FED_BIASES) | {k for k in state
                                      if _fed_by_noisy_bias(k)}
        _held_to_jax(state, want, want["lr"], noisy)
        assert o["all_reduces"] == 3
