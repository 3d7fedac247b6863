"""The port's slice end to end against the JAX package on the CPU: the
eval-mode multi-term ELBO (f32 and bf16 compute) and the serving
endpoints, on the same weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.serve import Sampler as JaxSampler
from mvae_tpu.train.loop import make_eval_step as jax_make_eval_step

from mvae_tpu_torch import ops
from mvae_tpu_torch.serve import Sampler, _bucket
from mvae_tpu_torch.train.loop import make_eval_step

from tests.test_torch_port_modules import (
    L, TOL, celeba_batch, jax_celeba, port_celeba)

MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
# the CelebA CLI's weights: image 1, attrs 10 (experiments/celeba/train.py:21)
LAMBDAS = [[1.0, 10.0]] * 3


@pytest.fixture(scope="module")
def f32():
    jm, params, state = jax_celeba()
    return jm, params, state, port_celeba(params, state)


def _jax_eval(jm, params, state, batch):
    step = jax_make_eval_step(jm, MASKS, LAMBDAS)
    total, per_term = step(params, state,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    return float(total), np.asarray(per_term)


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_eval_step_f32_matches_jax(f32):
    """total and per_term of the eval ELBO on a uint8 batch at the golden
    tolerance (rtol 1e-4)."""
    jm, params, state, pm = f32
    batch = celeba_batch(4, 11, uint8=True)
    want_total, want_terms = _jax_eval(jm, params, state, batch)
    step = make_eval_step(pm, MASKS, LAMBDAS, device="cpu")
    total, per_term = step(_port_batch(batch))
    assert per_term.shape == (3,)
    np.testing.assert_allclose(per_term.numpy(), want_terms, rtol=1e-4)
    np.testing.assert_allclose(float(total), want_total, rtol=1e-4)


def test_eval_step_device_data_gathers_the_same_rows(f32):
    """The (data, idx) form gathers on the device and scores what the
    plain batch of those rows scores."""
    *_, pm = f32
    data = _port_batch(celeba_batch(10, 12, uint8=True))
    idx = torch.tensor([7, 2, 2, 9])
    gathered = make_eval_step(pm, MASKS, LAMBDAS, device="cpu",
                              device_data=True)((data, idx))
    plain = make_eval_step(pm, MASKS, LAMBDAS, device="cpu")(
        {k: v[idx] for k, v in data.items()})
    for a, b in zip(gathered, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_eval_step_bf16_matches_jax():
    """bf16 compute (the CLI default) with bf16 input decode, against the
    JAX package in bf16. The loss is mostly the ln 2 per element of
    near-0.5 outputs, so bf16 rounding moves it little; the cast points
    are held module by module in test_bf16_modules_match_jax. Readings on
    this batch (CPU): the port in bf16 differs from JAX in bf16 by 4.5e-7
    relative on total (at most 9.1e-7 on any term over weight seeds 0-2),
    and from the port in f32 by 4.2e-5 on total (at least 5.2e-6 over
    seeds 0-2). Bound: rtol 3e-6, between the two readings."""
    jm, params, state = jax_celeba(compute_dtype=jnp.bfloat16)
    pm = port_celeba(params, state, compute_dtype=torch.bfloat16)
    batch = celeba_batch(4, 13, uint8=True)
    want_total, want_terms = _jax_eval(jm, params, state, batch)
    total, per_term = make_eval_step(pm, MASKS, LAMBDAS, device="cpu")(
        _port_batch(batch))
    np.testing.assert_allclose(float(total), want_total, rtol=3e-6)
    np.testing.assert_allclose(per_term.numpy(), want_terms, rtol=3e-6)
    f32_total, _ = make_eval_step(port_celeba(params, state), MASKS, LAMBDAS,
                                  device="cpu")(_port_batch(batch))
    assert abs(float(total) / float(f32_total) - 1) > 3e-6


@pytest.fixture(scope="module")
def samplers(f32):
    jm, params, state, pm = f32
    return JaxSampler(jm, params, state), Sampler(pm, device="cpu")


@pytest.mark.parametrize("names", [("image",), ("attrs",),
                                   ("attrs", "image")])
def test_embed_matches_jax(samplers, names):
    js, ps = samplers
    batch = celeba_batch(3, 14)             # bucket 4: one padded row
    inputs = {k: batch[k] for k in names}
    mu, lv = js.embed({k: jnp.asarray(v) for k, v in inputs.items()})
    p_mu, p_lv = ps.embed(inputs)
    assert p_mu.shape == (3, L)
    np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), **TOL)


def test_reconstruct_matches_jax(samplers):
    js, ps = samplers
    x = celeba_batch(3, 15)["image"]
    want = js.reconstruct({"image": jnp.asarray(x)})
    got = ps.reconstruct({"image": x})
    for k in ("image", "attrs"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_decode_from_injected_z_matches_jax(f32, samplers):
    """Both sampling paths end in decode_latents; the draws themselves
    cannot match (jax.random vs torch), so z is injected."""
    jm, params, state, _ = f32
    _, ps = samplers
    z = np.random.default_rng(16).normal(size=(5, L)).astype(np.float32)
    recons, _ = jm.decode(params, state, jnp.asarray(z), None, False)
    got = ps.decode_latents(z)
    for k in ("image", "attrs"):
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(jax.nn.sigmoid(recons[k])),
                                   **TOL)


def test_sampling_shapes_determinism_and_bucketing(samplers):
    _, ps = samplers
    assert [_bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    a = ps.sample(n=5, seed=3)
    assert a["image"].shape == (5, 64, 64, 3) and a["attrs"].shape == (5, 18)
    for v in a.values():
        assert torch.isfinite(v).all() and v.min() >= 0 and v.max() <= 1
    torch.testing.assert_close(ps.sample(n=5, seed=3)["image"], a["image"],
                               rtol=0, atol=0)
    # 5 and 8 share bucket 8: the same draw, sliced
    torch.testing.assert_close(ps.sample(n=8, seed=3)["image"][:5],
                               a["image"], rtol=0, atol=0)
    assert not torch.equal(ps.sample(n=5, seed=4)["image"], a["image"])


def test_conditional_sampling_uses_the_condition(samplers):
    _, ps = samplers
    attrs = celeba_batch(2, 17)["attrs"]
    a = ps.sample(n=3, condition={"attrs": attrs[:1]}, seed=1)
    b = ps.sample(n=3, condition={"attrs": 1.0 - attrs[:1]}, seed=1)
    assert a["image"].shape == (3, 64, 64, 3)
    assert not torch.allclose(a["attrs"], b["attrs"])
    torch.testing.assert_close(
        ps.sample(n=3, condition={"attrs": attrs[:1]}, seed=1)["attrs"],
        a["attrs"], rtol=0, atol=0)


def test_warmup_runs_every_endpoint_without_kernels_on_cpu(samplers):
    _, ps = samplers
    before = ops.launch_counts()
    ps.warmup(buckets=(1, 2))
    assert ops.launch_counts() == before
