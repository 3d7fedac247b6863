"""The port's MNIST and FashionMNIST families against the JAX package on
the CPU: the reference keys and the weight carry-across, encode, decode,
the losses (the CE too, with shared label rows), the eval ELBO, one Adam
train step with JAX's own eps (no dropout, no keep-mask), bf16 between
its two readings, the Sampler's softmax on text, the loaders, the PNG
writer, and the CLIs on `--device cpu` over a tiny IDX set, whose
checkpoints the JAX package's importer reads.

Same weights (`state_dict_from_jax`) and same numpy inputs on both
sides, at B <= 8 and n_latents 8 with the families' real layer widths.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvae_tpu.core.losses import (
    cross_entropy_with_logits as jax_cross_entropy)
from mvae_tpu.data.mnist import load_mnist as jax_load_mnist
from mvae_tpu.data.mnist import synthetic_mnist as jax_synthetic_mnist
from mvae_tpu.data.pipeline import batches as jax_batches
from mvae_tpu.models.fashionmnist import FashionMnistMVAE as JaxFashion
from mvae_tpu.models.mnist import MnistMVAE as JaxMnist
from mvae_tpu.serve import Sampler as JaxSampler
from mvae_tpu.train.driver import load_model_checkpoint as jax_load_model
from mvae_tpu.train.loop import make_eval_step as jax_make_eval_step
from mvae_tpu.train.loop import make_train_step as jax_make_train_step
from mvae_tpu.utils.png import save_image_grid as jax_save_image_grid
from mvae_tpu.utils.torch_export import export_state_dict
from mvae_tpu.utils.torch_import import import_checkpoint

import mvae_tpu_torch.experiments.fashionmnist.loglike as fashion_loglike
import mvae_tpu_torch.experiments.fashionmnist.sample as fashion_sample
import mvae_tpu_torch.experiments.fashionmnist.train as fashion_train
import mvae_tpu_torch.experiments.mnist.loglike as mnist_loglike
import mvae_tpu_torch.experiments.mnist.sample as mnist_sample
import mvae_tpu_torch.experiments.mnist.train as mnist_train
from mvae_tpu_torch.core.engine import multi_term_elbo
from mvae_tpu_torch.core.losses import cross_entropy_with_logits
from mvae_tpu_torch.data.mnist import load_mnist, synthetic_mnist, write_idx
from mvae_tpu_torch.data.pipeline import batches
from mvae_tpu_torch.models import FashionMnistMVAE, MnistMVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.checkpoint import BEST, CKPT
from mvae_tpu_torch.train.driver import load_model_checkpoint
from mvae_tpu_torch.train.loop import (
    draw_noise, make_eval_step, make_train_step)
from mvae_tpu_torch.utils.png import save_image_grid
from mvae_tpu_torch.utils.weights import state_dict_from_jax

from tests.test_torch_import import _build_fashionmnist, _build_mnist
from tests.test_torch_port_modules import TOL, rel_l1

L, B = 8, 6
MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3        # the CLIs' training weights
EVAL_LAMBDAS = [[1.0, 1.0]] * 3    # ... and their eval weights
LR = 1e-3                          # the CLIs' learning rate
FAMILIES = {"mnist": (JaxMnist, MnistMVAE, (784,), _build_mnist),
            "fashionmnist": (JaxFashion, FashionMnistMVAE, (28, 28, 1),
                             _build_fashionmnist)}
CLIS = {"mnist": (mnist_train, mnist_sample, mnist_loglike, "MNIST"),
        "fashionmnist": (fashion_train, fashion_sample, fashion_loglike,
                         "FashionMNIST")}


def jax_family(family, compute_dtype=None, seed=0):
    jm = FAMILIES[family][0](L, compute_dtype=compute_dtype)
    params, state = jm.init(jax.random.key(seed))
    return jm, jax.tree_util.tree_map(np.asarray, params), state


def port_family(family, params, state, compute_dtype=None):
    model = FAMILIES[family][1](L, compute_dtype, device="cpu")
    sd = state_dict_from_jax(family, params, state)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                          strict=True)
    return model


def family_batch(family, b, seed):
    rng = np.random.default_rng(seed)
    shape = FAMILIES[family][2]
    return {"image": rng.random((b,) + shape).astype(np.float32),
            "text": rng.integers(0, 10, b).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The port's side of every test here on one intra-op thread, restored
    after: the models run at a few rows, and a test run with several
    worker processes (pytest-xdist) shares the host's cores, where torch's
    default team of one thread a core makes each small op wait on threads
    that another process holds (the CLI runs took ten times their
    single-process time). It also keeps the process's first CPU exp on
    one thread (mvae_tpu_torch/device.py:warm_cpu_math)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def f32(request):
    family = request.param
    jm, params, state = jax_family(family)
    return family, jm, params, state, port_family(family, params, state)


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

def test_state_dict_keys_are_the_reference_keys(f32):
    """The port's keys are the reference model's (the torch builders of
    tests/test_torch_import.py), so its state_dict loads strict there."""
    family, *_, pm = f32
    ref = FAMILIES[family][3](L).state_dict()
    assert set(pm.state_dict()) == set(ref)
    for k, v in ref.items():
        assert pm.state_dict()[k].shape == v.shape, k


def test_state_dict_from_jax_is_the_exporter_bit_for_bit(f32):
    family, _, params, state, _ = f32
    want = export_state_dict(family, params, state)
    got = state_dict_from_jax(family, params, state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------------------------
# modules, losses, the eval ELBO (f32, rtol 1e-4)
# --------------------------------------------------------------------------

def test_encode_matches_jax(f32):
    family, jm, params, state, pm = f32
    batch = family_batch(family, B, 1)
    mu, lv, _ = jm.encode(params, state, _jax(batch), None, False)
    with torch.no_grad():
        p_mu, p_lv, moments = pm.encode(_torch(batch))
    assert p_mu.shape == (2, B, L) and moments == {"image": [], "text": []}
    np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), **TOL)


def test_decode_matches_jax(f32):
    family, jm, params, state, pm = f32
    z = np.random.default_rng(2).normal(size=(B, L)).astype(np.float32)
    want, _ = jm.decode(params, state, jnp.asarray(z), None, False)
    with torch.no_grad():
        got, moments = pm.decode(torch.from_numpy(z))
    assert moments == []
    for k in ("image", "text"):
        assert got[k].dtype == torch.float32
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)


def test_recon_losses_match_jax(f32):
    """Each modality's loss on logits of 3 * B rows against B shared
    target rows (row r reads target r mod B, as the ELBO's terms and the
    IWAE's samples do), against JAX's on the repeated targets."""
    family, jm, params, state, pm = f32
    batch = family_batch(family, B, 3)
    rng = np.random.default_rng(4)
    logits = {"image": 3 * rng.normal(size=(3 * B,) + FAMILIES[family][2]),
              "text": 3 * rng.normal(size=(3 * B, 10))}
    for name, lo in logits.items():
        lo = lo.astype(np.float32)
        want = jm.recon_loss(name, jnp.asarray(lo),
                             jnp.asarray(np.concatenate([batch[name]] * 3)))
        got = pm.recon_loss(name, torch.from_numpy(lo),
                            torch.from_numpy(batch[name]))
        assert got.shape == (3 * B,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=name)


def test_cross_entropy_matches_jax():
    """The CE with eps 1e-6 on the logits, per row, and its shared label
    rows."""
    rng = np.random.default_rng(5)
    logits = (4 * rng.normal(size=(12, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 4).astype(np.int32)
    want = jax_cross_entropy(jnp.asarray(logits),
                             jnp.asarray(np.tile(labels, 3)))
    got = cross_entropy_with_logits(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_eval_elbo_matches_jax(f32):
    """total and per_term of the eval step, with the CLIs' eval weights."""
    family, jm, params, state, pm = f32
    batch = family_batch(family, B, 6)
    total, per_term = jax_make_eval_step(jm, MASKS, EVAL_LAMBDAS)(
        params, state, _jax(batch))
    got, got_terms = make_eval_step(pm, MASKS, EVAL_LAMBDAS, device="cpu")(
        _torch(batch))
    np.testing.assert_allclose(got_terms.numpy(), np.asarray(per_term),
                               rtol=1e-4)
    np.testing.assert_allclose(float(got), float(total), rtol=1e-4)


# --------------------------------------------------------------------------
# training: no dropout, one Adam step
# --------------------------------------------------------------------------

def test_train_without_dropout_takes_no_keep_mask(f32):
    """A family whose dropout rate is 0 draws no keep-mask and trains with
    noise = (eps, None); eps is still required."""
    family, *_, pm = f32
    model = FAMILIES[family][1](L, device="cpu")
    assert model.dropout_rate == 0.0
    gen, twin = (torch.Generator().manual_seed(0) for _ in range(2))
    eps, keep = draw_noise(model, 3, B, gen)
    assert keep is None and torch.equal(eps, torch.randn((3, B, L),
                                                         generator=twin))
    assert torch.equal(gen.get_state(), twin.get_state())     # no more draws
    model.train()
    batch = _torch(family_batch(family, B, 7))
    masks, lambdas = torch.tensor(MASKS), torch.tensor(LAMBDAS)
    total, _ = multi_term_elbo(model, batch, masks, lambdas, 1.0, train=True,
                               noise=(eps, None))
    assert torch.isfinite(total)
    with pytest.raises(ValueError, match="noise"):
        multi_term_elbo(model, batch, masks, lambdas, 1.0, train=True,
                        noise=(None, None))


def _jax_eps(key, b):
    """The eps JAX's train step draws from `key`: split(key) -> sub, then
    multi_term_elbo's rngs[1] (engine.py:215, sampling.py:16)."""
    _, sub = jax.random.split(key)
    rngs = jax.random.split(sub, 3)
    return np.asarray(jax.random.normal(rngs[1], (3, b, L), jnp.float32))


def test_train_step_matches_jax(f32):
    """One make_train_step with Adam(1e-3), the CLIs' weights, beta 0.5
    and JAX's eps: the loss at rtol 1e-4, and every parameter after the
    step within 1e-4 of JAX's in relative Frobenius norm. Adam's first
    step moves each element by about lr whatever its gradient's size, so
    an element whose gradient is near 0 moves by an amount the rounding
    decides (FashionMNIST's conv2: 12 of 131072 elements 1e-3 apart
    relative): the update itself is held within 1e-3 of JAX's, in
    Frobenius norm (the largest reading about 5e-5)."""
    family, jm, params, state, _ = f32
    pm = port_family(family, params, state)
    batch = family_batch(family, B, 8)
    key = jax.random.key(9)
    tx = optax.adam(LR)
    j_params, _, _, _, loss, per_term = jax_make_train_step(
        jm, tx, MASKS, LAMBDAS)(
        jax.tree_util.tree_map(jnp.array, params), state,
        tx.init(params), key, _jax(batch), 0.5)
    step = make_train_step(pm, MASKS, LAMBDAS, lr=LR, device="cpu",
                           generator=torch.Generator())
    got, got_terms = step(_torch(batch), 0.5,
                          noise=(torch.tensor(_jax_eps(key, B)), None))
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-4)
    np.testing.assert_allclose(got_terms.numpy(), np.asarray(per_term),
                               rtol=1e-4)
    want = state_dict_from_jax(family, jax.tree_util.tree_map(
        np.asarray, j_params), state)
    before = state_dict_from_jax(family, params, state)
    for k, v in pm.state_dict().items():
        got = v.numpy()
        assert np.linalg.norm(got - want[k]) < 1e-4 * np.linalg.norm(
            want[k]), k
        moved = np.linalg.norm(want[k] - before[k])
        assert moved > 0 and np.linalg.norm(got - want[k]) < 1e-3 * moved, k


# --------------------------------------------------------------------------
# bf16
# --------------------------------------------------------------------------

def _outputs(family, jm, params, state, pb, pf, batch):
    """name -> (JAX bf16, port bf16, port f32) of encode, decode and the
    eval loss."""
    z = np.random.default_rng(10).normal(size=(B, L)).astype(np.float32)
    mu, lv, _ = jm.encode(params, state, _jax(batch), None, False)
    rec, _ = jm.decode(params, state, jnp.asarray(z), None, False)
    _, terms = jax_make_eval_step(jm, MASKS, EVAL_LAMBDAS)(
        params, state, _jax(batch))
    want = {"image mu": mu[0], "image logvar": lv[0], "text mu": mu[1],
            "text logvar": lv[1], "image logits": rec["image"],
            "text logits": rec["text"], "eval per_term": terms}
    outs = {}
    for m in (pb, pf):
        with torch.no_grad():
            p_mu, p_lv, _ = m.encode(_torch(batch))
            p_rec, _ = m.decode(torch.from_numpy(z))
        _, p_terms = make_eval_step(m, MASKS, EVAL_LAMBDAS, device="cpu")(
            _torch(batch))
        for name, v in zip(want, (p_mu[0], p_lv[0], p_mu[1], p_lv[1],
                                  p_rec["image"], p_rec["text"], p_terms)):
            outs.setdefault(name, []).append(v)
    return {k: (np.asarray(want[k], np.float32), *outs[k]) for k in want}


# Outputs that pass through a bf16 rounding, per family: each lies closer
# to JAX in bf16 than BF16_MARGIN times its gap to the port in f32
# (rel_l1). Readings on weight seeds 0-2 (CPU): MNIST 1.5e-7 to 5.8e-7
# from JAX, 4.6e-4 to 4.3e-3 from f32; FashionMNIST's image side 5.7e-7 to
# 4.0e-5 from JAX, 1.1e-3 to 4.9e-3 from f32 (ratios 8e-3 at most). The
# other outputs stay f32 throughout (FashionMNIST's label MLPs) and equal
# the port's f32 bit for bit. The eval loss, whose random-weight value
# barely moves with the rounding (1e-7 from f32), is held to JAX's bf16
# loss at the f32 tolerance.
BF16_OUTPUTS = {
    "mnist": ("image mu", "image logvar", "text mu", "text logvar",
              "image logits", "text logits"),
    "fashionmnist": ("image mu", "image logvar", "image logits"),
}
BF16_MARGIN = 0.1


def test_bf16_between_its_readings(f32):
    """bf16 compute: the bf16 outputs closer to JAX's bf16 than to the
    port's f32 by BF16_MARGIN, so a rounding point out of place (or a
    bf16 model that computes in f32) fails; the f32 ones bit-identical to
    the port in f32 and at the f32 tolerance of JAX."""
    family, _, params, state, pf = f32
    jm = FAMILIES[family][0](L, compute_dtype=jnp.bfloat16)
    pb = port_family(family, params, state, torch.bfloat16)
    outs = _outputs(family, jm, params, state, pb, pf,
                    family_batch(family, B, 11))
    for name, (want, got_b, got_f) in outs.items():
        assert got_b.dtype == torch.float32, name
        got_b, got_f = got_b.numpy(), got_f.numpy()
        if name == "eval per_term":
            np.testing.assert_allclose(got_b, want, rtol=1e-4)
            continue
        if name not in BF16_OUTPUTS[family]:
            np.testing.assert_array_equal(got_b, got_f, err_msg=name)
            np.testing.assert_allclose(got_b, want, **TOL, err_msg=name)
            continue
        to_jax, to_f32 = rel_l1(got_b, want), rel_l1(got_b, got_f)
        assert to_jax < BF16_MARGIN * to_f32, (name, to_jax, to_f32)


# --------------------------------------------------------------------------
# serving, loaders, PNG
# --------------------------------------------------------------------------

def test_sampler_softmax_on_text_sigmoid_on_image(f32):
    """reconstruct from the image: the text rows are a softmax (rows sum
    to 1) and the image a sigmoid, as the JAX Sampler activates them."""
    family, jm, params, state, pm = f32
    batch = family_batch(family, 3, 12)
    want = JaxSampler(jm, params, state).reconstruct(
        {"image": jnp.asarray(batch["image"])})
    got = Sampler(pm, device="cpu").reconstruct({"image": batch["image"]})
    for k in ("image", "text"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)
    np.testing.assert_allclose(got["text"].sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("variant,flatten,gz", [
    ("MNIST", True, False), ("FashionMNIST", False, True)])
def test_idx_loader_matches_jax(tmp_path, variant, flatten, gz):
    """IDX files written by write_idx (plain or .gz) read as the JAX
    package reads them; without files both fall back to one synthetic
    set."""
    images, labels = synthetic_mnist(30, seed=3)
    raw = tmp_path / variant / "raw"
    raw.mkdir(parents=True)
    sfx = ".gz" if gz else ""
    write_idx(str(raw / f"t10k-images-idx3-ubyte{sfx}"),
              np.round(images * 255))
    write_idx(str(raw / f"t10k-labels-idx1-ubyte{sfx}"), labels)
    got = load_mnist(str(tmp_path), train=False, variant=variant,
                     flatten=flatten, synthetic_ok=False)
    want = jax_load_mnist(str(tmp_path), train=False, variant=variant,
                          flatten=flatten, synthetic_ok=False)
    for k in ("image", "text"):
        assert got.arrays[k].dtype == want.arrays[k].dtype
        np.testing.assert_array_equal(got.arrays[k], want.arrays[k])
    for a, b in zip(synthetic_mnist(7, seed=5), jax_synthetic_mnist(7, 5)):
        np.testing.assert_array_equal(a, b)


def test_download_fetches_nothing(tmp_path, capsys, monkeypatch):
    """--download on a host with no egress (every fetch raises, and no
    URL is opened): the message, then the synthetic fallback."""
    import mvae_tpu_torch.data.download as dl

    def no_egress(url, dst, timeout=60.0):
        raise OSError("network unreachable")

    monkeypatch.setattr(dl, "_fetch", no_egress)
    ds = load_mnist(str(tmp_path), train=False, download=True)
    out = capsys.readouterr().out
    assert "--download failed" in out and "synthetic fallback" in out
    assert ds.arrays["image"].shape == (10000, 784)


def test_batches_match_jax():
    """The host iterator: in order with the ragged tail kept, or shuffled
    per epoch with the tail dropped, as the JAX package's."""
    images, labels = synthetic_mnist(23, seed=2)
    from mvae_tpu_torch.data.pipeline import ArrayDataset
    from mvae_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
    arrays = {"image": images, "text": labels}
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=3, epoch=2)):
        got = list(batches(ArrayDataset(arrays), 5, **kw))
        want = list(jax_batches(JaxArrayDataset(arrays), 5, **kw))
        assert len(got) == len(want) == (5 if not kw["shuffle"] else 4)
        for g, w in zip(got, want):
            for k in arrays:
                np.testing.assert_array_equal(g[k], w[k])


def test_png_writer_matches_jax(tmp_path):
    """The same bytes as the JAX package's writer, gray and RGB."""
    rng = np.random.default_rng(13)
    for shape in ((10, 28, 28, 1), (3, 64, 64, 3)):
        imgs = rng.random(shape).astype(np.float32)
        save_image_grid(str(tmp_path / "a.png"), imgs)
        jax_save_image_grid(str(tmp_path / "b.png"), imgs)
        a = (tmp_path / "a.png").read_bytes()
        assert a[:8] == b"\x89PNG\r\n\x1a\n"
        assert a == (tmp_path / "b.png").read_bytes()


# --------------------------------------------------------------------------
# the CLIs on the CPU over a tiny IDX set
# --------------------------------------------------------------------------

N_TRAIN, N_TEST, CLI_B = 40, 20, 10
CLI_FLAGS = ["--device", "cpu", "--n-latents", str(L), "--batch-size",
             str(CLI_B), "--log-interval", "2", "--annealing-epochs", "1",
             "--seed", "3", "--f32"]


def _idx_set(root, variant):
    raw = os.path.join(root, variant, "raw")
    os.makedirs(raw)
    for train, n, stem in ((True, N_TRAIN, "train"), (False, N_TEST, "t10k")):
        images, labels = synthetic_mnist(n, seed=int(not train))
        write_idx(os.path.join(raw, f"{stem}-images-idx3-ubyte"),
                  np.round(images * 255))
        write_idx(os.path.join(raw, f"{stem}-labels-idx1-ubyte"), labels)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = main(argv)
    return value, buf.getvalue()


@pytest.fixture(scope="module", params=sorted(CLIS))
def cli_run(request, tmp_path_factory):
    """A family's train CLI on the CPU (--f32: bf16 is held above) for one
    epoch, then --resume for a second; (family, out dir, data dir,
    stdout)."""
    family = request.param
    train, _, _, variant = CLIS[family]
    tmp = tmp_path_factory.mktemp(family)
    data, out = str(tmp / "data"), str(tmp / "models")
    _idx_set(data, variant)
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.backends.cudnn, "allow_tf32",
               torch.backends.cudnn.allow_tf32)
    try:
        flags = CLI_FLAGS + ["--data-dir", data, "--out-dir", out]
        _, text = _run(train.main, flags + ["--epochs", "1"])
        _, text2 = _run(train.main, flags + [
            "--epochs", "2", "--resume", os.path.join(out, CKPT)])
    finally:
        mp.undo()
    return family, out, data, text + text2


def test_cli_trains_and_resumes(cli_run):
    """Two epochs over the IDX files (no synthetic fallback), resumed at
    epoch 1, a finite test loss each epoch, both files naming the
    family."""
    family, out, _, text = cli_run
    assert "synthetic" not in text
    assert f"resumed from {os.path.join(out, CKPT)} at epoch 1" in text
    tests = [float(ln.split()[-1]) for ln in text.splitlines()
             if ln.startswith("====> Test Loss")]
    assert len(tests) == 2 and all(np.isfinite(tests))
    assert "Train Epoch: 2 [0/40" in text
    for name in (CKPT, BEST):
        ckpt = torch.load(os.path.join(out, name), map_location="cpu",
                          weights_only=True)
        assert ckpt["model"] == family and ckpt["n_latents"] == L
    assert torch.load(os.path.join(out, CKPT), weights_only=True)[
        "epoch"] == 2


def test_cli_samples_in_four_modes(cli_run, tmp_path):
    """The sample CLI from model_best.pth.tar: the prior, an image of a
    digit, a label, both; a PNG grid and one text line a sample."""
    family, out, data, _ = cli_run
    sample = CLIS[family][1]
    label = int(load_mnist(data, train=False, variant=CLIS[family][3])
                .arrays["text"][0])
    for i, extra in enumerate(([], ["--condition-on-image", str(label)],
                               ["--condition-on-text", str(label)],
                               ["--condition-on-image", str(label),
                                "--condition-on-text", str(label)])):
        d = tmp_path / str(i)
        res, _ = _run(sample.main, [os.path.join(out, BEST), "--device",
                                    "cpu", "--n-samples", "10", "--data-dir",
                                    data, "--out-dir", str(d), *extra])
        assert (d / "sample_image.png").read_bytes()[:8] == \
            b"\x89PNG\r\n\x1a\n"
        lines = (d / "sample_text.txt").read_text().splitlines()
        assert len(lines) == 10 and lines[3].startswith("Text (3): ")
        np.testing.assert_allclose(res["text"].sum(-1).numpy(), 1.0,
                                   rtol=1e-6)


def test_cli_loglike_every_target(cli_run):
    """The loglike CLI for image, text and joint: the reference's line, a
    finite negative estimate, every example of the first batches
    counted."""
    family, out, data, _ = cli_run
    loglike = CLIS[family][2]
    for target in ("image", "text", "joint"):
        ll, text = _run(loglike.main, [
            os.path.join(out, BEST), "--device", "cpu", "--target", target,
            "--n-samples", "4", "--batch-size", "8", "--max-examples", "12",
            "--data-dir", data])
        assert np.isfinite(ll) and ll < 0
        assert f"====> log p({target}) >= {ll:.4f}  (K=4, N=16)" in text


def test_cli_checkpoint_loads_into_jax(cli_run, tmp_path):
    """model_best.pth.tar read by the JAX package's importer gives the
    port's eval posteriors (f32, the golden tolerance)."""
    family, out, data, _ = cli_run
    src = os.path.join(out, BEST)
    jax_ctor, port_ctor = FAMILIES[family][:2]
    path, meta = import_checkpoint(family, src, str(tmp_path))
    assert meta["n_latents"] == L
    jm, params, state, _ = jax_load_model(path, jax_ctor)
    pm, _ = load_model_checkpoint(src, port_ctor, device="cpu")
    batch = family_batch(family, 4, 14)
    for names in (("image",), ("text",), ("image", "text")):
        mu, lv = jm.infer(params, state, {k: jnp.asarray(batch[k])
                                          for k in names})
        with torch.no_grad():
            p_mu, p_lv = pm.infer({k: torch.from_numpy(batch[k])
                                   for k in names})
        np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), **TOL)
        np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), **TOL)
