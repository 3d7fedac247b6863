"""tools/profile_celeba19.py (celeba19's step by stage, the counterpart of
scripts/profile_celeba19.py) against the JAX package on the CPU: at
n_latents 8, B = 4 and the T = 21 terms of celeba19_step_terms, from the
same weights (state_dict_from_jax, BN randomized) and numpy inputs, each
stage's function equals the JAX function the script times:

  - encode's mu and logvar (eval mode: no dropout, running statistics)
    against the model's encode, rtol 1e-5, atol 1e-6;
  - the fused posteriors against jax.vmap(masked_product_of_experts) and
    z against mu + eps exp(lv / 2) with eps injected, rtol 1e-5, atol 1e-6;
  - the grouped decode (train mode) against engine.py:_decode_grouped: the
    logits of every call that trains a decoder group at rtol 1e-4 (with
    the module tests' atol 1e-5 for the logits near 0, which the BN's
    batch statistics round apart by up to 7e-6), and the loss stack at
    the terms' support against JAX's losses of its logits at rtol 1e-4;
  - the full forward's ELBO (train mode, beta 0.5, JAX's noise) against
    engine.py:multi_term_elbo at rtol 1e-4, as the golden tests hold it.

Then the tool's main on the CPU: its two JSON lines, the seven stages in
the JAX script's order, and no device metric.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.core.engine import _decode_grouped as jax_decode_grouped
from mvae_tpu.core.engine import multi_term_elbo as jax_multi_term_elbo
from mvae_tpu.core.poe import masked_product_of_experts

from mvae_tpu_torch.core.engine import decode_plan
from mvae_tpu_torch.core.subsets import (
    celeba19_recon_support, celeba19_step_terms)
from mvae_tpu_torch.tools import measure, profile_celeba19

from tests.test_torch_port_celeba19 import jax_model, jax_noise, port_model
from tests.test_torch_port_modules import TOL, celeba_batch

ROOT = Path(__file__).resolve().parents[1]
B = 4
T = 21
STAGE_TOL = dict(rtol=1e-5, atol=1e-6)
RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """JAX's model and the port's from its weights, a float batch, the
    step's terms and the CLI's support."""
    jm, params, state = jax_model(seed=3)
    pm = port_model(params, state)
    batch = celeba_batch(B, 8)
    masks, lambdas = celeba19_step_terms(np.random.default_rng(1), 1, 18,
                                         *profile_celeba19.LAMBDAS)
    return dict(jm=jm, params=params, state=state, pm=pm, batch=batch,
                masks=np.asarray(masks, np.float32),
                lambdas=np.asarray(lambdas, np.float32),
                support=celeba19_recon_support(1, 18))


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_terms_are_the_jax_scripts(setup):
    """T = 21 terms of one sampled subset, the masks' first row the joint
    term (scripts/profile_celeba19.py:63-67)."""
    assert setup["masks"].shape == (T, 19)
    np.testing.assert_array_equal(setup["masks"][0], np.ones(19))
    src = (ROOT / "scripts" / "profile_celeba19.py").read_text()
    assert "celeba19_step_terms(np.random.default_rng(1), 1, N_ATTRS" in src
    assert "1.0, 10.0)" in src


def test_encode_stage_matches_jax(setup):
    jm, pm = setup["jm"], setup["pm"]
    mu, lv, _ = jm.encode(setup["params"], setup["state"],
                          _jax(setup["batch"]), None, False)
    pm.eval()
    with torch.no_grad():
        p_mu, p_lv = profile_celeba19.encode(pm, _torch(setup["batch"]))
    assert p_mu.shape == (19, B, 8)
    np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), **STAGE_TOL)
    np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), **STAGE_TOL)


def test_fuse_stage_matches_jax(setup):
    rng = np.random.default_rng(5)
    mu = rng.normal(size=(19, B, 8)).astype(np.float32)
    lv = (0.5 * rng.normal(size=(19, B, 8))).astype(np.float32)
    eps = rng.normal(size=(T, B, 8)).astype(np.float32)
    pd_mu, pd_lv = jax.vmap(masked_product_of_experts,
                            in_axes=(None, None, 0))(
        jnp.asarray(mu), jnp.asarray(lv), jnp.asarray(setup["masks"]))
    z = pd_mu + jnp.asarray(eps) * jnp.exp(0.5 * pd_lv)
    got = profile_celeba19.fuse(torch.from_numpy(mu), torch.from_numpy(lv),
                                torch.from_numpy(setup["masks"]),
                                torch.from_numpy(eps))
    for g, w in zip(got, (pd_mu, pd_lv, z)):
        assert g.shape == (T, B, 8)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STAGE_TOL)
    # eval: z = mu
    assert torch.equal(profile_celeba19.fuse(
        torch.from_numpy(mu), torch.from_numpy(lv),
        torch.from_numpy(setup["masks"]))[2], got[0])


def test_grouped_decode_stage_matches_jax(setup, monkeypatch):
    """Train mode on both sides (per-term BN statistics); every call that
    trains a decoder group gives JAX's logits of its terms (the gathered
    experts' at their support columns), and the loss stack JAX's losses
    at the support."""
    jm, pm, support = setup["jm"], setup["pm"], setup["support"]
    z = np.random.default_rng(6).normal(size=(T, B, 8)).astype(np.float32)
    keys = jax.random.split(jax.random.key(2), T)
    recons, _ = jax.jit(lambda p, s, zz, kk: jax_decode_grouped(
        jm, p, s, zz, kk, True, support))(setup["params"], setup["state"],
                                           jnp.asarray(z), keys)
    pm.train()
    plan = decode_plan(pm, support)
    seen = []
    own = pm.group_losses

    def spy(name, got, inputs):
        seen.append(got[name].detach())
        return own(name, got, inputs)

    monkeypatch.setattr(pm, "group_losses", spy)
    with torch.no_grad():
        stack = profile_celeba19.decode_grouped(
            pm, torch.from_numpy(z), plan, _torch(setup["batch"]))
    live = [(g.name, c.index) for g in plan for c in g.calls if c.grad]
    assert len(seen) == len(live) and {n for n, _ in live} == {
        "image", "attrs"}
    for (name, index), got in zip(live, seen):
        want = np.asarray(recons[name])[list(index)]
        got = got.numpy().reshape(want.shape)
        if name == "attrs":
            cols = support[list(index)][:, None, 1:].astype(bool)
            cols = np.broadcast_to(cols, want.shape)
            want, got = want[cols], got[cols]
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    rep = {k: jnp.asarray(np.concatenate([v] * T))
           for k, v in setup["batch"].items()}
    flat = {k: v.reshape((T * B,) + v.shape[2:]) for k, v in recons.items()}
    losses = np.asarray(jm.recon_losses(flat, rep)).reshape(T, B, 19)
    on = np.broadcast_to(support[:, None, :].astype(bool), losses.shape)
    assert stack.shape == (T, B, 19)
    np.testing.assert_allclose(stack.numpy()[on], losses[on], rtol=RTOL)


def test_full_forward_stage_matches_jax(setup):
    jm, pm = setup["jm"], setup["pm"]
    key = jax.random.key(9)
    total, _, _ = jax.jit(lambda p, s, x: jax_multi_term_elbo(
        jm, p, s, x, jnp.asarray(setup["masks"]),
        jnp.asarray(setup["lambdas"]), key, 0.5, train=True,
        recon_support=setup["support"]))(setup["params"], setup["state"],
                                         _jax(setup["batch"]))
    pm.train()
    with torch.no_grad():
        got = profile_celeba19.forward(
            pm, _torch(setup["batch"]), torch.from_numpy(setup["masks"]),
            torch.from_numpy(setup["lambdas"]),
            tuple(torch.from_numpy(a) for a in jax_noise(key, T, B)),
            decode_plan(pm, setup["support"]), 0.5)
    np.testing.assert_allclose(float(got), float(total), rtol=RTOL)


def test_main_on_the_cpu(monkeypatch, capsys):
    """Without a card the tool raises before it builds anything, unless
    --device cpu; then one JSON line a precision, each what main returns:
    the seven stages in the JAX script's order with positive wall ms and
    no device metric."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(measure, "smi_line", lambda: 1 / 0)
    argv = ["--batch", "2", "--k", "1", "--n-latents", "8"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_celeba19.main(argv)
    out = profile_celeba19.main(argv + ["--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines == out and [r["precision"] for r in out] == ["f32", "bf16"]
    src = (ROOT / "scripts" / "profile_celeba19.py").read_text()
    jax_rows = [re.sub(r" \(.*\)$", "", name) for name in re.findall(
        r'\("([^"]+)"(?: % T)?, [a-z_]+\)', src)]
    assert jax_rows == list(profile_celeba19.STAGES[:6])
    for rec in out:
        assert rec["device"] == "cpu" and rec["terms"] == T
        assert [r["stage"] for r in rec["stages"]] == list(
            profile_celeba19.STAGES)
        for row in rec["stages"]:
            assert row["wall_ms"] > 0
            assert (row["device_ms"] is row["launches"] is row["records_lost"]
                    is None)
