"""The port's training CLI and epoch driver on the CPU, against the JAX
package's: the windows of row indices and KL weights each epoch feeds the
train step, the log lines, the synthetic CelebA set, the eval average with
its ragged tail, and the `.pth.tar` checkpoint (written, resumed bit for
bit, served, and read by the JAX package's importer).

Driver comparisons run both drivers with stand-in steps whose losses are
sums of the attributes of the rows they were given, so every logged
number follows from the rows and weights the driver chose. The JAX
driver is shown a single device: under the conftest's eight it would
build a mesh, which the port does not have.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvae_tpu.train.driver as jax_driver
import mvae_tpu.train.loop as jax_loop
from mvae_tpu.data.celeba import (
    load_celeba as jax_load_celeba, synthetic_celeba as jax_synthetic)
from mvae_tpu.data.pipeline import batches as jax_batches
from mvae_tpu.data.pipeline import num_batches as jax_num_batches
from mvae_tpu.models.celeba import CelebaMVAE as JaxCelebaMVAE
from mvae_tpu.utils.cli import train_parser as jax_train_parser
from mvae_tpu.utils.torch_import import import_checkpoint

import mvae_tpu_torch.experiments.celeba.train as cli
import mvae_tpu_torch.train.driver as driver
import mvae_tpu_torch.train.loop as loop
from mvae_tpu_torch.data.celeba import load_celeba, synthetic_celeba
from mvae_tpu_torch.data.pipeline import num_batches
from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.checkpoint import BEST, CKPT

MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3
LOG_LINE = re.compile(
    r"^(Train Epoch: \d+ \[\d+/\d+ \(\d+%\)\]\tLoss: -?\d+\.\d{6}\t"
    r"Annealing-Factor: \d\.\d{3}|====> Epoch: \d+\tLoss: -?\d+\.\d{4}"
    r"|====> Test Loss: -?\d+\.\d{4}|====> Throughput: \d+\.\d{2} "
    r"steps/sec)$")
# n_train rows of which the last 3 fall off the epoch (batch 4), in
# windows of 2, 2, 1 steps; n_test rows: 2 full batches and a tail of 2
N_TRAIN, N_TEST, BATCH, K = 23, 10, 4, 2
FLAGS = ["--n-latents", "8", "--batch-size", str(BATCH), "--log-interval",
         str(K), "--seed", "5"]


def _logs(text):
    """The reference's log lines of a run, Throughput left out (a clock)."""
    return [ln for ln in text.splitlines() if LOG_LINE.match(ln)
            and not ln.startswith("====> Throughput")]


def _datasets(tiny_seed=0):
    return (synthetic_celeba(N_TRAIN, seed=tiny_seed),
            synthetic_celeba(N_TEST, seed=tiny_seed + 1))


class _OneDevice:
    """`jax` as the JAX driver sees it: one device."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def devices():
        return jax.devices()[:1]


def _attr_sums(attrs, idx):
    """The stand-in loss of each batch: the sum of its rows' attributes."""
    return np.asarray(attrs)[np.asarray(idx)].reshape(
        len(idx), -1).sum(-1).astype(np.float32)


def _run_jax_driver(monkeypatch, argv, train_ds, test_ds):
    """JAX's run_training with stand-in steps; returns the (idxs, betas)
    windows and the checkpoint metas it saved."""
    windows, saved = [], []

    def multi_train(*_a, **_k):
        def step(params, state, opt_state, rng, data, idxs, betas):
            idxs = np.asarray(idxs)[:, 0, :]
            windows.append((idxs, np.asarray(betas)))
            return (params, state, opt_state, rng,
                    jnp.asarray(_attr_sums(data["attrs"][0], idxs)))
        return step

    def multi_eval(*_a, **_k):
        return lambda params, state, data, idxs: jnp.asarray(
            _attr_sums(data["attrs"][0], np.asarray(idxs)[:, 0, :]))

    def eval_step(*_a, **_k):
        return lambda params, state, batch: (
            jnp.float32(np.asarray(batch["attrs"]).sum()), None)

    monkeypatch.setattr(jax_driver, "jax", _OneDevice())
    monkeypatch.setattr(jax_loop, "make_multi_train_step", multi_train)
    monkeypatch.setattr(jax_loop, "make_multi_eval_step", multi_eval)
    monkeypatch.setattr(jax_loop, "make_eval_step", eval_step)
    monkeypatch.setattr(jax_driver, "save_checkpoint",
                        lambda st, meta, best, out: saved.append(
                            (meta["epoch"], best, meta["best_loss"],
                             meta["test_loss"])))
    args = jax_train_parser(n_latents=8, epochs=3, annealing_epochs=2,
                            lr=1e-4).parse_args(argv)
    jax_driver.run_training(JaxCelebaMVAE(8), train_ds, test_ds, args, MASKS,
                            LAMBDAS, out_dir="unused", meta={})
    return windows, saved


def _run_port_driver(monkeypatch, argv, train_ds, test_ds):
    windows, saved = [], []

    def multi_train(model, *_a, **_k):
        def step(data, idxs, betas):
            windows.append((idxs.numpy(), betas.numpy()))
            return torch.from_numpy(_attr_sums(data["attrs"], idxs))
        step.optimizer = torch.optim.Adam(model.parameters())
        return step

    def eval_step(*_a, **_k):
        return lambda batch: (batch[0]["attrs"][batch[1]].sum(), None)

    monkeypatch.setattr(loop, "make_multi_train_step", multi_train)
    monkeypatch.setattr(loop, "make_eval_step", eval_step)
    monkeypatch.setattr(driver, "save_checkpoint",
                        lambda p, best, out: saved.append(
                            (p["epoch"], best, p["best_loss"],
                             p["test_loss"])))
    args = cli.parse_train_args(cli.parser(), argv + ["--epochs", "3",
                                                      "--annealing-epochs",
                                                      "2"])
    driver.run_training(CelebaMVAE(8, device="cpu"), train_ds, test_ds, args,
                        MASKS, LAMBDAS, out_dir="unused", meta={},
                        device="cpu")
    return windows, saved


def test_windows_betas_and_logs_match_jax(monkeypatch, capsys):
    """Three epochs, annealing over two, a ragged training tail and a
    ragged test tail: the index matrix and the KL weights of every window
    equal JAX's bit for bit, and so do the log lines and the test loss,
    best loss and is-best flag of every checkpoint."""
    train_ds, test_ds = _datasets()
    j_windows, j_saved = _run_jax_driver(monkeypatch, FLAGS, train_ds,
                                         test_ds)
    j_logs = _logs(capsys.readouterr().out)
    p_windows, p_saved = _run_port_driver(monkeypatch, FLAGS, train_ds,
                                          test_ds)
    p_logs = _logs(capsys.readouterr().out)
    assert len(j_windows) == 3 * 3 and [len(w[0]) for w in j_windows[:3]] \
        == [2, 2, 1]
    assert len(p_windows) == len(j_windows)
    for (pi, pb), (ji, jb) in zip(p_windows, j_windows):
        np.testing.assert_array_equal(pi, ji)
        assert pb.dtype == jb.dtype == np.float32
        np.testing.assert_array_equal(pb, jb)
    betas = [w[1][0] for w in j_windows]
    assert betas[0] < betas[2] < 1.0 == betas[-1]
    assert p_saved == j_saved and [s[0] for s in p_saved] == [1, 2, 3]
    assert len(j_logs) == 3 * (3 + 2) and p_logs == j_logs


@pytest.mark.parametrize("partition", ["train", "val", "test"])
def test_synthetic_celeba_is_bit_identical(partition, tmp_path, capsys):
    """The loader's no-files fallback gives the JAX package's arrays."""
    got = load_celeba(str(tmp_path), partition, synthetic_n=7)
    want = jax_load_celeba(str(tmp_path), partition, synthetic_n=7)
    assert "synthetic fallback" in capsys.readouterr().out
    for k in ("image", "attrs"):
        assert got.arrays[k].dtype == want.arrays[k].dtype
        np.testing.assert_array_equal(got.arrays[k], want.arrays[k])
    np.testing.assert_array_equal(synthetic_celeba(5, seed=3).arrays["image"],
                                  jax_synthetic(5, seed=3).arrays["image"])


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_num_batches_match_jax(drop_remainder):
    """The batch count of an epoch: the ragged tail dropped in training
    and kept otherwise, as the JAX package counts it and as its batches
    iterator yields them."""
    ds = synthetic_celeba(N_TRAIN, seed=4)
    got = num_batches(N_TRAIN, BATCH, drop_remainder)
    assert got == jax_num_batches(N_TRAIN, BATCH, drop_remainder) == (
        5 if drop_remainder else 6)
    assert got == len(list(jax_batches(ds, BATCH, shuffle=drop_remainder,
                                       drop_remainder=drop_remainder)))


def _cli(monkeypatch, tmp, *extra):
    """The CLI's main on tiny synthetic sets, f32, on the CPU; returns its
    stdout."""
    train_ds, test_ds = _datasets()
    monkeypatch.setattr(cli, "load_celeba", lambda data_dir, part, **kw:
                        train_ds if part == "train" else test_ds)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    cli.main(FLAGS + ["--device", "cpu", "--f32", "--annealing-epochs", "1",
                      "--out-dir", str(tmp), *extra])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two CLI runs of the tiny model: two epochs straight, and one epoch
    then --resume for the second; stdout of each."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, steps in (("straight", [["--epochs", "2"]]),
                            ("resumed", [["--epochs", "1"], None])):
            tmp = tmp_path_factory.mktemp(name)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                for extra in steps:
                    if extra is None:
                        extra = ["--epochs", "2", "--resume",
                                 str(tmp / CKPT)]
                    _cli(mp, tmp, *extra)
            out[name] = (tmp, buf.getvalue())
    finally:
        mp.undo()
    return out


def test_cli_two_epochs_log_and_checkpoints(runs):
    """The reference's log lines, both files, and a payload that loads
    with weights_only=True in the reference layout."""
    tmp, text = runs["straight"]
    logs = [ln for ln in text.splitlines() if LOG_LINE.match(ln)]
    assert [ln.split(":")[0] for ln in logs] == (
        ["Train Epoch"] * 3 + ["====> Epoch", "====> Test Loss"]
        + ["Train Epoch"] * 3
        + ["====> Epoch", "====> Throughput", "====> Test Loss"])
    for name in (CKPT, BEST):
        ckpt = torch.load(tmp / name, map_location="cpu", weights_only=True)
        assert {"state_dict", "best_loss", "n_latents", "optimizer", "epoch",
                "generator", "model", "test_loss"} <= set(ckpt)
        assert ckpt["model"] == "celeba" and ckpt["n_latents"] == 8
    ckpt = torch.load(tmp / CKPT, map_location="cpu", weights_only=True)
    assert ckpt["epoch"] == 2 and np.isfinite(ckpt["test_loss"])
    assert ckpt["best_loss"] == min(ckpt["best_loss"], ckpt["test_loss"])


def test_resume_continues_bit_for_bit(runs):
    """One epoch, then --resume for the second, gives the parameters, the
    running statistics and the optimizer state of two epochs straight."""
    (a_dir, a_text), (b_dir, b_text) = runs["straight"], runs["resumed"]
    assert f"resumed from {b_dir / CKPT} at epoch 1" in b_text
    assert _logs(a_text) == _logs(b_text)
    a = torch.load(a_dir / CKPT, map_location="cpu", weights_only=True)
    b = torch.load(b_dir / CKPT, map_location="cpu", weights_only=True)
    assert a["epoch"] == b["epoch"] == 2
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    assert torch.equal(a["generator"], b["generator"])


def test_profile_dir_writes_a_trace(monkeypatch, tmp_path):
    """--profile-dir traces the second window of the first epoch into a
    Chrome trace that holds the train step's work."""
    _cli(monkeypatch, tmp_path / "models", "--epochs", "1", "--profile-dir",
         str(tmp_path / "trace"))
    trace = (tmp_path / "trace" / "trace.json").read_text()
    assert '"traceEvents"' in trace and "conv" in trace


def _port_model(path):
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = CelebaMVAE(8, device="cpu")
    model.load_state_dict(sd["state_dict"])
    return model


def test_best_checkpoint_serves_and_loads_into_jax(runs, tmp_path):
    """model_best.pth.tar serves through Sampler.from_checkpoint, and the
    JAX package's importer reads it: its eval loss on one batch equals the
    port's (f32, rtol 1e-4)."""
    src = runs["straight"][0] / BEST
    sampler = Sampler.from_checkpoint(src, device="cpu")
    _, test_ds = _datasets()
    batch = {k: v[:4] for k, v in test_ds.arrays.items()}
    rec = sampler.reconstruct({"image": batch["image"]})
    assert rec["image"].shape == (4, 64, 64, 3)
    assert bool(torch.isfinite(rec["image"]).all())

    path, meta = import_checkpoint("celeba", str(src), str(tmp_path))
    assert meta["n_latents"] == 8 and meta["epoch"] in (1, 2)
    jm, params, state, _ = jax_driver.load_model_checkpoint(path,
                                                            JaxCelebaMVAE)
    want, _ = jax_loop.make_eval_step(jm, MASKS, LAMBDAS)(
        params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = loop.make_eval_step(_port_model(src), MASKS, LAMBDAS,
                                 device="cpu")(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_eval_average_with_ragged_tail_matches_jax(runs, tmp_path):
    """The driver's test loss over 10 rows at batch 4 (two batches read
    back as one buffer, a tail of two) against JAX's make_multi_eval_step
    plus its tail step, weighted by rows as the JAX driver weights them,
    from the same trained weights (f32, rtol 1e-4). Both read the tail
    from the uint8 rows: the JAX driver feeds its tail step the float rows
    instead (driver.py:371), a quirk ROADMAP records."""
    src = runs["straight"][0] / CKPT
    model = _port_model(src)
    _, test_ds = _datasets()
    data = driver.to_device_data(test_ds, "cpu")
    got = driver.evaluate(
        loop.make_eval_step(model, MASKS, LAMBDAS, device="cpu",
                            device_data=True), data, N_TEST, BATCH)
    assert data["image"].dtype == torch.uint8

    path, _ = import_checkpoint("celeba", str(src), str(tmp_path))
    jm, params, state, _ = jax_driver.load_model_checkpoint(path,
                                                            JaxCelebaMVAE)
    jdata = {k: jnp.asarray(v.numpy())[None] for k, v in data.items()}
    idxs = jnp.arange(8).reshape(2, 1, 4)
    losses = jax_loop.make_multi_eval_step(jm, MASKS, LAMBDAS)(
        params, state, jdata, idxs)
    tail = {k: np.asarray(v)[8:] for k, v in test_ds.arrays.items()}
    tail["image"] = np.round(tail["image"] * 255.0).astype(np.uint8)
    t_loss, _ = jax_loop.make_eval_step(jm, MASKS, LAMBDAS)(
        params, state, {k: jnp.asarray(v) for k, v in tail.items()})
    meter = jax_loop.AverageMeter()
    for v in np.asarray(losses):
        meter.update(float(v), BATCH)
    meter.update(float(t_loss), 2)
    np.testing.assert_allclose(got, meter.avg, rtol=1e-4)
