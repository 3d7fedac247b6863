"""The port's IWAE log-likelihood against the JAX package on the CPU, with
JAX's own draws (eps_k = normal(key_k, (B, D)), keys = split(rng, K)):
MNIST and FashionMNIST at K in {1, 5}, CelebA (BN doing real work) at
B = 2, K = 2; the chunked decode against one decode; the CelebA sample
and loglike CLIs on `--device cpu`; and Sampler.from_checkpoint building
the family a file names or holds."""

import contextlib
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.core.loglike import iwae_log_marginal as jax_iwae

import mvae_tpu_torch.core.loglike as loglike
import mvae_tpu_torch.experiments.celeba.loglike as celeba_loglike
import mvae_tpu_torch.experiments.celeba.sample as celeba_sample
from mvae_tpu_torch.core.loglike import decode_chunks, iwae_log_marginal
from mvae_tpu_torch.models import CelebaMVAE, FashionMnistMVAE, MnistMVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.utils.weights import state_dict_from_jax

from tests.test_torch_port_families import (  # noqa: F401 (a fixture)
    family_batch, jax_family, one_intra_op_thread, port_family)
from tests.test_torch_port_modules import (
    L, celeba_batch, jax_celeba, port_celeba)


def jax_eps(rng, k, b, d):
    """The draws of mvae_tpu/core/loglike.py:45-58 for key rng."""
    return np.stack([np.asarray(jax.random.normal(key, (b, d), jnp.float32))
                     for key in jax.random.split(rng, k)])


def _models(family):
    if family == "celeba":
        jm, params, state = jax_celeba()
        return jm, params, state, port_celeba(params, state), \
            celeba_batch(2, 5)
    jm, params, state = jax_family(family)
    return (jm, params, state, port_family(family, params, state),
            family_batch(family, 4, 5))


@pytest.mark.parametrize("family,k,proposal,targets", [
    ("mnist", 1, (1, 1), None),
    ("mnist", 5, (1, 1), None),
    ("mnist", 5, (1, 0), ("image",)),     # q from the image alone
    ("fashionmnist", 1, (1, 1), None),
    ("fashionmnist", 5, (1, 1), ("text",)),
    ("celeba", 2, (1, 1), None),
])
def test_iwae_matches_jax(family, k, proposal, targets):
    """log p(targets) per example, f32 rtol 1e-4; targets None: every
    modality (the CLI's "joint")."""
    jm, params, state, pm, batch = _models(family)
    targets = list(targets or pm.modalities)
    rng = jax.random.key(17)
    want = jax_iwae(jm, params, state,
                    {k_: jnp.asarray(v) for k_, v in batch.items()},
                    jnp.asarray(proposal, jnp.float32), targets, rng, k)
    b = len(next(iter(batch.values())))
    eps = torch.from_numpy(jax_eps(rng, k, b, pm.n_latents))
    got = iwae_log_marginal(pm, {k_: torch.from_numpy(v)
                                 for k_, v in batch.items()},
                            list(proposal), targets, k, eps=eps)
    assert got.shape == (b,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_decode_chunks_are_equal_and_fewest():
    budget = loglike.DECODE_ELEMENTS
    assert decode_chunks(100, 100, 12306) == 1        # CelebA's K=100, B=100
    assert decode_chunks(100, 100, 2 * budget // 10 ** 4) == 2
    assert decode_chunks(6, 1, 2 * budget) == 6       # one sample too big
    assert decode_chunks(5, 100, budget // 200) == 5  # 5 has no divisor < 5


def test_chunked_decode_equals_one_decode(monkeypatch):
    """K = 6 samples in chunks of 2 rows of samples give the one-decode
    estimate (the same rows through the same layers; f32 rtol 1e-6)."""
    pm, batch = _models("mnist")[3:]
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    eps = torch.randn((6, 4, L), generator=torch.Generator().manual_seed(1))
    whole = iwae_log_marginal(pm, inputs, [1, 1], ["image", "text"], 6,
                              eps=eps)
    decodes = []
    decode = pm.decode
    monkeypatch.setattr(pm, "decode", lambda z: decodes.append(
        z.shape[0]) or decode(z))
    monkeypatch.setattr(loglike, "DECODE_ELEMENTS", 2 * 4 * 785)
    parts = iwae_log_marginal(pm, inputs, [1, 1], ["image", "text"], 6,
                              eps=eps)
    assert decodes == [8, 8, 8]
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-6)


def test_iwae_draws_from_its_generator():
    """Without eps the draws come from the generator: one seed, one
    estimate; K = 1 with eps 0 is the ELBO at the posterior mean."""
    pm, batch = _models("mnist")[3:]
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    a, b = (iwae_log_marginal(pm, inputs, [1, 1], ["image"], 3,
                              generator=torch.Generator().manual_seed(4))
            for _ in range(2))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        iwae_log_marginal(pm, inputs, [1, 1], ["image"], 3)
    zero = iwae_log_marginal(pm, inputs, [1, 1], ["image"], 1,
                             eps=torch.zeros((1, 4, L)))
    mu, lv = pm.infer(inputs)
    rec, _ = pm.decode(mu)
    want = (-pm.recon_loss("image", rec["image"], inputs["image"])
            - 0.5 * (mu.square() - lv).sum(-1))
    np.testing.assert_allclose(zero.numpy(), want.detach().numpy(),
                               rtol=1e-5)


# --------------------------------------------------------------------------
# the CelebA sample and loglike CLIs, Sampler.from_checkpoint
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def celeba_ckpt(tmp_path_factory):
    """A CelebaMVAE(8) file as the train CLI writes it (f32 weights, the
    family named)."""
    path = tmp_path_factory.mktemp("celeba") / "model_best.pth.tar"
    model = CelebaMVAE(L, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    torch.save({"state_dict": model.state_dict(), "n_latents": L,
                "model": "celeba", "best_loss": 1.0}, path)
    return str(path)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = main(argv)
    return value, buf.getvalue()


def test_celeba_loglike_cli(celeba_ckpt, tmp_path, monkeypatch):
    """The reference's line, and its value the mean of the estimates over
    the examples it counted (the synthetic test set, batches of 3, the
    draws from the seeded generator)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    data = str(tmp_path / "data")
    ll, text = _run(celeba_loglike.main, [
        celeba_ckpt, "--device", "cpu", "--target", "joint", "--n-samples",
        "2", "--batch-size", "3", "--max-examples", "5", "--data-dir", data,
        "--seed", "7"])
    assert f"====> log p(joint) >= {ll:.4f}  (K=2, N=6)" in text
    from mvae_tpu_torch.data.celeba import load_celeba
    from mvae_tpu_torch.train.driver import load_model_checkpoint
    model, _ = load_model_checkpoint(celeba_ckpt, CelebaMVAE, device="cpu")
    test = load_celeba(data, "test").arrays
    gen = torch.Generator().manual_seed(7)
    vals = [iwae_log_marginal(model, {k: torch.from_numpy(v[lo:lo + 3])
                                      for k, v in test.items()},
                              [1, 1], ["image", "attrs"], 2, generator=gen)
            for lo in (0, 3)]
    assert math.isclose(ll, float(torch.cat(vals).mean()), rel_tol=1e-6)


def test_celeba_sample_cli(celeba_ckpt, tmp_path):
    """Both spellings of the attribute flag, the image of an attribute,
    the prior: a PNG grid and one line of attribute names a sample."""
    data = str(tmp_path / "data")
    for i, extra in enumerate(([], ["--condition-on-attrs", "Smiling"],
                               ["--condition-on-text", "Male"],
                               ["--condition-on-image", "Bangs"])):
        out = tmp_path / str(i)
        res, _ = _run(celeba_sample.main, [
            celeba_ckpt, "--device", "cpu", "--n-samples", "5",
            "--data-dir", data, "--out-dir", str(out), *extra])
        assert res["image"].shape == (5, 64, 64, 3)
        assert (out / "sample_image.png").read_bytes()[:4] == b"\x89PNG"
        assert len((out / "sample_attrs.txt").read_text()
                   .splitlines()) == 5
    with pytest.raises(SystemExit):
        celeba_sample.main([celeba_ckpt, "--device", "cpu",
                            "--condition-on-attrs", "Eyeglasses "])


@pytest.mark.parametrize("cls,family,named", [
    (MnistMVAE, "mnist", True), (MnistMVAE, "mnist", False),
    (FashionMnistMVAE, "fashionmnist", False), (CelebaMVAE, "celeba", True)])
def test_sampler_from_checkpoint_builds_the_family(tmp_path, cls, family,
                                                   named):
    """The family a file names (the port's own) or, without a name (the
    reference's and export_checkpoint's files), the one its keys hold."""
    model = cls(L, device="cpu")
    payload = {"state_dict": model.state_dict(), "n_latents": L}
    if named:
        payload["model"] = family
    torch.save(payload, tmp_path / "m.pth.tar")
    sampler = Sampler.from_checkpoint(tmp_path / "m.pth.tar", device="cpu")
    assert type(sampler.model) is cls
    for k, v in model.state_dict().items():
        assert torch.equal(sampler.model.state_dict()[k], v), k


def test_state_dict_from_jax_refuses_an_unported_family():
    """Every family of the JAX package is ported (vision the last); a
    name outside them is refused, naming the families there are."""
    with pytest.raises(ValueError, match="celeba40.*vision"):
        state_dict_from_jax("celeba40", {}, {})
