"""The data-parallel driver of the port on the CPU (train/driver.py under
a process group): the MNIST train CLI as two processes started with
--coordinator, --process-id and --n-processes (gloo), resident and
streamed from the host; CelebA's run_training with its BN statistics
shared, on two spawned ranks; and the resident windows of N ranks against
the index matrix the JAX driver dispatches on the suite's 8-device mesh.
"""

import contextlib
import io
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvae_tpu.train.driver as jax_driver
import mvae_tpu.train.loop as jax_loop
from mvae_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
from mvae_tpu.models.mnist import MnistMVAE as JaxMnist
from mvae_tpu.utils.cli import train_parser as jax_train_parser

from mvae_tpu_torch.data.mnist import synthetic_mnist, write_idx
from mvae_tpu_torch.data.pipeline import ArrayDataset
from mvae_tpu_torch.models import CelebaMVAE, MnistMVAE
from mvae_tpu_torch.parallel.distributed import process_rows
from mvae_tpu_torch.tools import dp_check
from mvae_tpu_torch.train import driver
from mvae_tpu_torch.train.checkpoint import BEST, CKPT, load_checkpoint
from mvae_tpu_torch.train.loop import make_eval_step

from tests import _torch_dp_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TRAIN, N_TEST, BATCH = 400, 111, 20
CLI_FLAGS = ["--device", "cpu", "--f32", "--n-latents", "8", "--batch-size",
             str(BATCH), "--log-interval", "5", "--annealing-epochs", "1",
             "--epochs", "2", "--seed", "3"]
# every rank of the CLI runs this: the CLI's main, then its model saved
RANK_MAIN = """
import sys, torch
torch.set_num_threads(1)
from mvae_tpu_torch.experiments.mnist import train
model = train.main(sys.argv[2:])
torch.save(model.state_dict(), sys.argv[1])
"""


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """This process's side on one intra-op thread, restored after (see
    tests/test_torch_port_families.py)."""
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
    """A small MNIST IDX set: 400 train rows, 111 test rows (odd: a row
    that no shard holds, and ragged local tails)."""
    root = tmp_path_factory.mktemp("mnist")
    raw = root / "MNIST" / "raw"
    raw.mkdir(parents=True)
    for train, n, stem in ((True, N_TRAIN, "train"), (False, N_TEST, "t10k")):
        images, labels = synthetic_mnist(n, seed=int(not train))
        write_idx(str(raw / f"{stem}-images-idx3-ubyte"),
                  np.round(images * 255))
        write_idx(str(raw / f"{stem}-labels-idx1-ubyte"), labels)
    return str(root)


def _cli_ranks(tmp, data_dir, extra):
    """The MNIST train CLI as 2 processes over gloo, each with an out dir
    of its own; returns [(stdout, its model's state_dict, out dir)]."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs, outs = [], []
    for r in range(2):
        out = os.path.join(tmp, f"out{r}")
        argv = CLI_FLAGS + extra + [
            "--data-dir", data_dir, "--out-dir", out, "--coordinator",
            f"127.0.0.1:{port}", "--process-id", str(r), "--n-processes",
            "2"]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, os.path.join(tmp, f"m{r}.pt")]
            + argv, env=env, cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
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


@pytest.fixture(scope="module")
def cli_runs(mnist_dir, tmp_path_factory):
    """mode -> (mode, data dir, _cli_ranks' ranks), each mode run once."""
    runs = {}

    def get(mode):
        if mode not in runs:
            extra = [] if mode == "resident" else ["--no-device-data"]
            tmp = str(tmp_path_factory.mktemp(mode))
            runs[mode] = mode, mnist_dir, _cli_ranks(tmp, mnist_dir, extra)
        return runs[mode]
    return get


@pytest.fixture(params=["resident", "streaming"])
def cli_run(request, cli_runs):
    return cli_runs(request.param)


def test_cli_ranks_agree_and_only_rank_0_logs_and_writes(cli_run):
    """Both ranks end with the same parameters; rank 0 printed the
    reference's log lines, the data-parallel line and the pipeline, and
    wrote both checkpoint files; rank 1 printed and wrote nothing."""
    mode, _, ((out0, sd0, dir0), (out1, sd1, dir1)) = cli_run
    for k, v in sd0.items():
        assert torch.equal(v, sd1[k]), k
    assert "data-parallel over 2 processes (backend gloo)" in out0
    assert ("device-resident" if mode == "resident" else "host streaming") \
        in out0
    assert out0.count("====> Test Loss") == 2
    assert "Train Epoch: 2 [" in out0 and "====> Throughput" in out0
    assert out1 == ""
    assert sorted(os.listdir(dir0)) == sorted([BEST, CKPT])
    assert not os.path.exists(dir1)


def test_cli_test_loss_is_one_process_eval(cli_run):
    """The test loss rank 0 wrote is the port's single-process eval of the
    same weights over all 111 test rows (rtol 1e-5: the rows' sums taken
    per rank and added)."""
    _, data_dir, ((_, sd0, dir0), _) = cli_run
    from mvae_tpu_torch.data.mnist import load_mnist
    ckpt = load_checkpoint(os.path.join(dir0, CKPT), device="cpu")
    model = MnistMVAE(8, device="cpu")
    model.load_state_dict(sd0)
    test_ds = load_mnist(data_dir, train=False)
    ev = make_eval_step(model, [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]],
                        [[1.0, 1.0]] * 3, device="cpu")
    want = driver.evaluate_host(ev, test_ds, BATCH, "cpu")
    np.testing.assert_allclose(ckpt["test_loss"], want, rtol=1e-5)
    assert ckpt["epoch"] == 2


def test_streamed_ranks_train_as_one_process(cli_runs, tmp_path):
    """Host streaming: both ranks iterate the global batches of one
    process and keep their rows, so two epochs on two ranks end where one
    process ends (MNIST has no BN: the gradients' average is the only
    collective; Adam over 40 steps, within 1e-4 in relative norm). The
    resident ranks take their own shards' permutations instead."""
    _, data_dir, ((_, sd0, _), _) = cli_runs("streaming")
    from mvae_tpu_torch.experiments.mnist import train
    with contextlib.redirect_stdout(io.StringIO()):
        model = train.main(CLI_FLAGS + ["--no-device-data", "--data-dir",
                                        data_dir, "--out-dir",
                                        str(tmp_path)])
    for k, v in model.state_dict().items():
        gap = float((sd0[k] - v).norm())
        assert gap <= 1e-4 * float(v.norm()), (k, gap)


# --------------------------------------------------------------------------
# CelebA's driver with BN on two spawned ranks
# --------------------------------------------------------------------------

def _celeba_set(n, seed):
    rng = np.random.default_rng(seed)
    return ArrayDataset({
        "image": rng.random((n, 64, 64, 3)).astype(np.float32),
        "attrs": (rng.random((n, 18)) < 0.3).astype(np.float32)})


@pytest.fixture(scope="module")
def celeba_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("celeba_dp")
    payload = dict(train=_celeba_set(24, 0), test=_celeba_set(11, 1),
                   out=str(tmp))
    outs = dp_check.spawn_ranks(2, ranks.celeba_driver, payload,
                                device="cpu", timeout_s=180)
    return payload, outs


def test_celeba_driver_ranks_agree_and_eval_as_one(celeba_ranks):
    """CelebaMVAE(8), B = 8 (4 a rank), 2 epochs resident with the BN
    statistics shared: both ranks end with the same parameters and
    running statistics, rank 0 alone logged and wrote, and the test loss
    is the single-process eval of the same weights over all 11 rows."""
    payload, ((out0, sd0), (out1, sd1)) = celeba_ranks
    for k, v in sd0.items():
        assert torch.equal(v, sd1[k]), k
    assert out1 == "" and out0.count("====> Test Loss") == 2
    assert "a shard of 1/2 a rank" in out0
    ckpt = load_checkpoint(os.path.join(payload["out"], "r0", CKPT),
                           device="cpu")
    assert not os.path.exists(os.path.join(payload["out"], "r1"))
    model = CelebaMVAE(8, device="cpu")
    model.load_state_dict(sd0)
    ev = make_eval_step(model, ranks.MASKS, ranks.LAMBDAS, device="cpu",
                        device_data=True)
    want = driver.evaluate(ev, driver.to_device_data(payload["test"], "cpu"),
                           11, 8)
    np.testing.assert_allclose(ckpt["test_loss"], want, rtol=1e-5)


# --------------------------------------------------------------------------
# the resident windows against the JAX driver's on 8 devices
# --------------------------------------------------------------------------

def test_resident_windows_match_jax_mesh_driver(monkeypatch):
    """The JAX driver on the suite's 8-device mesh (B = 16: 8-way data
    parallel, 2 rows a shard) dispatches (k, 8, 2) index matrices; the
    port's rank r of 8 takes, window by window, its shard's rows
    (shard_rows) in the order epoch_windows gives it, and those equal the
    JAX matrix's column r, two epochs over 203 rows (3 dropped)."""
    n, b_global, k = 203, 16, 3
    assert jax.device_count() == 8
    rng = np.random.default_rng(0)
    arrays = {"image": rng.random((n, 784)).astype(np.float32),
              "text": rng.integers(0, 10, n).astype(np.int32)}
    want = []

    def jax_multi(*_a, **_k):
        def step(params, state, opt_state, rng_, data, idxs, betas):
            want.append(np.asarray(idxs))
            return params, state, opt_state, rng_, jnp.zeros(len(idxs))
        return step

    monkeypatch.setattr(jax_loop, "make_multi_train_step", jax_multi)
    monkeypatch.setattr(jax_loop, "make_multi_eval_step", lambda *a, **kw: (
        lambda params, state, data, idxs: jnp.zeros(len(idxs))))
    monkeypatch.setattr(jax_loop, "make_eval_step", lambda *a, **kw: (
        lambda params, state, batch: (jnp.float32(0.0), None)))
    monkeypatch.setattr(jax_driver, "save_checkpoint", lambda *a: None)
    args = jax_train_parser(n_latents=8, epochs=2, annealing_epochs=1,
                            lr=1e-3).parse_args([
        "--batch-size", str(b_global), "--log-interval", str(k),
        "--seed", "7"])
    with contextlib.redirect_stdout(io.StringIO()):
        jax_driver.run_training(
            JaxMnist(8), JaxArrayDataset(arrays), JaxArrayDataset(arrays),
            args, [[1.0, 1.0]], [[1.0, 1.0]], out_dir="unused",
            meta={})
    world, b = 8, b_global // 8
    rows = driver.shard_rows(n, 0, world)
    n_loc = rows.stop - rows.start
    port = []
    for epoch in (1, 2):
        per_rank = [list(driver.epoch_windows(7, epoch, n_loc, b, k, r))
                    for r in range(world)]
        for w in range(len(per_rank[0])):
            port.append(np.stack([per_rank[r][w][1]
                                  for r in range(world)], 1))
    assert len(port) == len(want) == 2 * 4
    for g, w in zip(port, want):
        assert g.shape == w.shape and g.shape[1:] == (world, b)
        np.testing.assert_array_equal(g, w)
    assert process_rows(n - n % world, 3, world) == (75, 100)
    assert [driver.shard_rows(n, r, world).start for r in (0, 7)] == [0, 175]
