"""Weight carry-across: the port's own copy of the CelebA exporter against
the JAX package's, and the `.pth.tar` interchange into the port's Sampler."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.models.celeba import CelebaMVAE as JaxCelebaMVAE
from mvae_tpu.serve import Sampler as JaxSampler
from mvae_tpu.train.checkpoint import save_checkpoint
from mvae_tpu.utils.torch_export import export_checkpoint, export_state_dict

from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.utils.weights import (
    load_reference_checkpoint, state_dict_from_jax)

from tests.test_torch_port_modules import L, TOL, celeba_batch, jax_celeba


@pytest.fixture(scope="module")
def jax_model():
    return jax_celeba()


def test_state_dict_from_jax_is_the_exporter_bit_for_bit(jax_model):
    _, params, state = jax_model
    want = export_state_dict("celeba", params, state)
    got = state_dict_from_jax("celeba", params, state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_state_dict_loads_strict_into_the_port(jax_model):
    _, params, state = jax_model
    model = CelebaMVAE(L, device="cpu")
    sd = state_dict_from_jax("celeba", params, state)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                          strict=True)
    assert set(model.state_dict()) == set(sd)
    w = model.state_dict()["image_encoder.classifier.0.weight"]
    np.testing.assert_array_equal(w.numpy(),
                                  sd["image_encoder.classifier.0.weight"])


def test_checkpoint_interchange_serves_the_same_embedding(tmp_path):
    """JAX msgpack checkpoint -> export_checkpoint -> .pth.tar -> the
    port's Sampler.from_checkpoint: embed equals the JAX Sampler's."""
    model = JaxCelebaMVAE(L)
    params, state = model.init(jax.random.key(3))
    save_checkpoint({"params": params, "state": state},
                    {"model": "celeba", "n_latents": L,
                     "best_loss": np.float64(321.5)},
                    is_best=True, folder=str(tmp_path))
    src = str(tmp_path / "model_best.msgpack")
    out, _ = export_checkpoint("celeba", src, str(tmp_path / "best.pth.tar"))
    ps = Sampler.from_checkpoint(out, device="cpu")
    js = JaxSampler.from_checkpoint(src, JaxCelebaMVAE)
    batch = celeba_batch(3, 21)
    mu, lv = js.embed({k: jnp.asarray(v) for k, v in batch.items()})
    p_mu, p_lv = ps.embed(batch)
    np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), **TOL)


def test_reference_checkpoint_loads_weights_only_with_numpy_scalars(
        tmp_path):
    """A numpy scalar in best_loss is read under weights_only=True through
    an allowlist, never by turning weights_only off."""
    path = tmp_path / "ckpt.pth.tar"
    sd = {"a.weight": torch.ones(2, 3)}
    torch.save({"state_dict": sd, "n_latents": L,
                "best_loss": np.float64(12.25), "optimizer": None}, path)
    got, meta = load_reference_checkpoint(path, device="cpu")
    torch.testing.assert_close(got["a.weight"], sd["a.weight"])
    assert meta == {"n_latents": L, "best_loss": 12.25}
