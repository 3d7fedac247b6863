"""The driver under a model axis (train/driver.py with parallel/mesh.py's
grid) on the CPU: the MNIST train CLI as four processes at --batch-size 6
(dp2 x tp2, JAX's mesh line), resident and streamed; its checkpoints in
the reference layout, round trips between a grid and one device in both
directions (the model, and Adam's moments sliced); CelebA at batch 100 on
three ranks (dp1 x tp3: nothing divides, every parameter replicated).

Trap (f) of ROADMAP Queue 3 in the driver: the resident shards and their
permutations, and the streamed rows, are the dp index's (by global rank
the two tp ranks of an index would step on other rows, and their
replicated parameters would part).
"""

import contextlib
import io
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.models.mnist import MnistMVAE as JaxMnist
from mvae_tpu.train.driver import load_model_checkpoint as jax_load_model
from mvae_tpu.utils.torch_import import import_checkpoint

from mvae_tpu_torch.data.celeba import synthetic_celeba
from mvae_tpu_torch.data.mnist import synthetic_mnist, write_idx
from mvae_tpu_torch.experiments.mnist import train
from mvae_tpu_torch.models import MnistMVAE
from mvae_tpu_torch.parallel import mesh
from mvae_tpu_torch.tools import dp_check
from mvae_tpu_torch.train.checkpoint import BEST, CKPT, load_checkpoint
from mvae_tpu_torch.train.driver import load_model_checkpoint

from tests import _torch_dp_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, BATCH = 4, 6
FLAGS = ["--device", "cpu", "--f32", "--n-latents", "8", "--batch-size",
         str(BATCH), "--log-interval", "5", "--annealing-epochs", "1",
         "--seed", "3"]
MESH = ("mesh over all 4 devices: 2-way data x 2-way tensor/expert "
        "parallel (batch 6 is not divisible by 4; the leftover factor "
        "shards parameters, not nothing)")
# every rank of the CLI runs this: the CLI's main, then its model in the
# reference layout (gathered over its tp group: every rank calls it)
RANK_MAIN = """
import sys, torch
torch.set_num_threads(1)
from mvae_tpu_torch.experiments.mnist import train
from mvae_tpu_torch.train.checkpoint import model_state
model = train.main(sys.argv[2:])
torch.save(model_state(model), sys.argv[1])
"""


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    """An MNIST IDX set of 120 train rows (20 steps of 6) and 37 test rows
    (a row no dp shard holds)."""
    root = tmp_path_factory.mktemp("mnist_tp")
    raw = root / "MNIST" / "raw"
    raw.mkdir(parents=True)
    for train_, n, stem in ((True, 120, "train"), (False, 37, "t10k")):
        images, labels = synthetic_mnist(n, seed=int(not train_))
        write_idx(str(raw / f"{stem}-images-idx3-ubyte"),
                  np.round(images * 255))
        write_idx(str(raw / f"{stem}-labels-idx1-ubyte"), labels)
    return str(root)


def _cli_ranks(tmp, argv, world=WORLD):
    """The MNIST train CLI as `world` processes over gloo, each with an
    out dir of its own: [(stdout, its gathered state_dict, out dir)]."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    os.makedirs(tmp)
    procs, outs = [], []
    for r in range(world):
        out = os.path.join(tmp, f"out{r}")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, os.path.join(tmp, f"m{r}.pt")]
            + FLAGS + argv + [
                "--out-dir", out, "--coordinator", f"127.0.0.1:{port}",
                "--process-id", str(r), "--n-processes", str(world)],
            env=env, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, f"rank {r}:\n{stderr[-3000:]}"
            outs.append((stdout, torch.load(os.path.join(tmp, f"m{r}.pt")),
                         os.path.join(tmp, f"out{r}")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return outs


def _single(argv):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        model = train.main(FLAGS + argv)
    return buf.getvalue(), model


@pytest.fixture(scope="module")
def runs(mnist_dir, tmp_path_factory):
    """The grid's epoch 1 (resident) and two dp ranks' at the same batch;
    one device resuming the grid's for epoch 2; the grid resuming that
    for epoch 3; the grid's and one process's streamed epoch 1."""
    tmp = str(tmp_path_factory.mktemp("tp_cli"))
    data = ["--data-dir", mnist_dir]
    grid1 = _cli_ranks(os.path.join(tmp, "grid1"), data + ["--epochs", "1"])
    dp2 = _cli_ranks(os.path.join(tmp, "dp2"), data + ["--epochs", "1"],
                     world=2)
    one_dir = os.path.join(tmp, "one")
    one2 = _single(data + ["--epochs", "2", "--out-dir", one_dir,
                           "--resume", os.path.join(grid1[0][2], CKPT)])
    grid3 = _cli_ranks(os.path.join(tmp, "grid3"), data + [
        "--epochs", "3", "--resume", os.path.join(one_dir, CKPT)])
    streamed = _cli_ranks(os.path.join(tmp, "streamed"), data + [
        "--epochs", "1", "--no-device-data"])
    single_dir = os.path.join(tmp, "single")
    single = _single(data + ["--epochs", "1", "--no-device-data",
                             "--out-dir", single_dir])
    return dict(grid1=grid1, dp2=dp2, one2=one2, one_dir=one_dir,
                grid3=grid3, streamed=streamed, single=single,
                single_dir=single_dir)


def test_batch_6_on_4_ranks_trains_as_dp2_tp2(runs):
    """--n-processes 4 --batch-size 6 trains on one node: rank 0 prints
    JAX's mesh line and the reference's lines and writes both files; the
    other ranks print and write nothing; every rank ends with the same
    parameters in the reference layout."""
    (out0, sd0, dir0), *rest = runs["grid1"]
    assert MESH in out0.splitlines()
    assert "device-resident" in out0 and "====> Test Loss" in out0
    assert sorted(os.listdir(dir0)) == sorted([BEST, CKPT])
    for out, sd, d in rest:
        assert out == "" and not os.path.exists(d)
        for k, v in sd0.items():
            assert torch.equal(v, sd[k]), k
    assert set(sd0) == set(MnistMVAE(8, device="cpu").state_dict())


def test_resident_grid_trains_as_its_dp_ranks(runs):
    """Resident: dp index d of the grid keeps shard d and permutes it by
    SeedSequence([seed, epoch, d]), as rank d of two dp ranks at the same
    batch does (trap f: by global rank, a tp rank would step on another
    index's rows), so the grid's epoch ends where theirs does (MNIST has
    no BN; within 1e-4 in relative norm)."""
    (out0, sd0, _), *_ = runs["grid1"]
    (dp_out, dp_sd, _), _ = runs["dp2"]
    assert "data-parallel over 2 processes" in dp_out
    for k, v in dp_sd.items():
        gap = float((sd0[k] - v).norm())
        assert gap <= 1e-4 * float(v.norm()), (k, gap)


def test_streamed_grid_trains_as_one_process(runs):
    """Host streaming: every rank keeps its dp index's rows of the global
    batches (trap f, streamed), so the grid's epoch ends where one
    process's does (MNIST has no BN; within 1e-4 in relative norm) and
    its test loss is one process's."""
    (out0, sd0, dir0), *_ = runs["streamed"]
    assert "host streaming" in out0
    _, model = runs["single"]
    for k, v in model.state_dict().items():
        gap = float((sd0[k] - v).norm())
        assert gap <= 1e-4 * float(v.norm()), (k, gap)
    got = load_checkpoint(os.path.join(dir0, CKPT), device="cpu")
    one = load_checkpoint(os.path.join(runs["single_dir"], CKPT),
                          device="cpu")
    np.testing.assert_allclose(got["test_loss"], one["test_loss"],
                               rtol=1e-5)


def test_grid_checkpoint_loads_on_one_device_and_into_jax(runs, tmp_path):
    """The grid's .pth.tar is the reference layout: strict load into a
    one-device model gives the ranks' gathered state; the JAX package's
    importer reads it and gives the port's posteriors."""
    (_, sd0, dir0), *_ = runs["grid1"]
    src = os.path.join(dir0, BEST)
    model, meta = load_model_checkpoint(src, MnistMVAE, device="cpu")
    assert meta["model"] == "mnist"
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd0[k]), k
    path, _ = import_checkpoint("mnist", src, str(tmp_path))
    jm, params, state, _ = jax_load_model(path, JaxMnist)
    rng = np.random.default_rng(2)
    image = rng.random((4, 784)).astype(np.float32)
    mu, lv = jm.infer(params, state, {"image": jnp.asarray(image)})
    with torch.no_grad():
        p_mu, p_lv = model.infer({"image": torch.from_numpy(image)})
    np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(p_lv.numpy(), np.asarray(lv), rtol=1e-4,
                               atol=1e-5)


def test_grid_checkpoint_resumes_on_one_device(runs):
    """One device resumes the grid's epoch-1 checkpoint: the model, Adam's
    state (its moments indexed as one device's parameters) and the noise
    stream load, and epoch 2 trains."""
    out, _ = runs["one2"]
    assert any(line.startswith("resumed from ") and line.endswith(
        "at epoch 1") for line in out.splitlines())
    ckpt = load_checkpoint(os.path.join(runs["one_dir"], CKPT), device="cpu")
    assert ckpt["epoch"] == 2 and np.isfinite(ckpt["test_loss"])


def test_one_device_checkpoint_resumes_on_the_grid(runs):
    """The grid resumes one device's epoch-2 checkpoint and trains epoch 3;
    every rank ends equal."""
    (out0, sd0, dir0), *rest = runs["grid3"]
    assert any(line.startswith("resumed from ") and line.endswith(
        "at epoch 2") for line in out0.splitlines())
    assert "====> Epoch: 3" in out0 and MESH in out0.splitlines()
    assert load_checkpoint(os.path.join(dir0, CKPT), device="cpu")[
        "epoch"] == 3
    for _, sd, _ in rest:
        for k, v in sd0.items():
            assert torch.equal(v, sd[k]), k


def test_adam_moments_come_back_sliced(runs):
    """A reference-layout checkpoint loaded on two tp ranks (batch 5:
    dp1 x tp2): each rank's parameters and Adam moments are its slices of
    the file's (the plan's spans), and gathering them gives the file's
    state_dict back."""
    path = os.path.join(runs["one_dir"], CKPT)
    ckpt = load_checkpoint(path, device="cpu")
    outs = dp_check.spawn_ranks(2, ranks.tp_resume, dict(path=path, batch=5),
                                device="cpu", timeout_s=120)
    full = MnistMVAE(8, device="cpu")
    names = [n for n, _ in full.named_parameters()]
    plan = mesh.tp_plan(full, 2)
    moments = {k: {names[i]: v[k] for i, v in ckpt["optimizer"][
        "state"].items()} for k in ("exp_avg", "exp_avg_sq")}
    sharded = 0
    for r, o in enumerate(outs):
        for n, spec in plan.items():
            want = {"param": ckpt["state_dict"][n],
                    **{k: moments[k][n] for k in moments}}
            if isinstance(spec, mesh.Shard):
                lo, hi = mesh._span(spec, want["param"].shape[spec.dim], r, 2)
                want = {k: v.narrow(spec.dim, lo, hi - lo)
                        for k, v in want.items()}
                sharded += 1
            assert torch.equal(o["params"][n], want["param"]), n
            for k in moments:
                assert torch.equal(o[k][n], want[k]), (k, n)
        for k, v in ckpt["state_dict"].items():
            assert torch.equal(o["gathered"][k], v), k
    assert sharded == 2 * 19      # 7 + 6 + 6 sharded tensors a rank


def test_batch_100_on_3_ranks_trains_replicated(tmp_path):
    """CelebA's batch of 100 on 3 ranks is dp1 x tp3 (JAX's own case at
    3 devices); 512 % 3 != 0, so every parameter replicates and the ranks
    repeat each other's work: the mesh line, full-shape parameters, equal
    states, and one epoch trains."""
    payload = dict(train=synthetic_celeba(100, seed=0),
                   test=synthetic_celeba(11, seed=1), out=str(tmp_path))
    outs = dp_check.spawn_ranks(3, ranks.celeba_b100, payload, device="cpu",
                                timeout_s=240)
    assert all(p is None for p in mesh.tp_plan(
        ranks.CelebaMVAE(8, device="cpu"), 3).values())
    out0, sd0 = outs[0]
    assert ("mesh over all 3 devices: 1-way data x 3-way tensor/expert "
            "parallel") in out0
    assert "====> Test Loss" in out0
    full = ranks.CelebaMVAE(8, device="cpu").state_dict()
    for out, sd in outs[1:]:
        assert out == ""
        for k, v in sd0.items():
            assert v.shape == full[k].shape and torch.equal(v, sd[k]), k
