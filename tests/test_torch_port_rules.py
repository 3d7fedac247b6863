"""The port's ground rules: it imports nothing of JAX or of the JAX
package, and its entry points run on the CUDA card unless asked for the
CPU."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mvae_tpu_torch
import mvae_tpu_torch.experiments.celeba.train as celeba_cli
from mvae_tpu_torch.core.engine import multi_term_elbo
from mvae_tpu_torch.models import (
    Celeba19MVAE, FashionMnistMVAE, MnistMVAE, MultiMnistMVAE, VisionMVAE)
from mvae_tpu_torch.models.celeba import CelebaMVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.train.driver import load_model_checkpoint
from mvae_tpu_torch.train.loop import (
    make_eval_step, make_multi_train_step, make_train_step)
from mvae_tpu_torch.utils.cli import parse_train_args
from mvae_tpu_torch.utils.weights import load_reference_checkpoint

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "mvae_tpu_torch"
MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        mvae_tpu_torch.__path__, "mvae_tpu_torch."))


def test_import_pulls_in_no_jax_and_no_mvae_tpu():
    """A fresh interpreter imports the package and every submodule; no
    jax* module and no mvae_tpu / mvae_tpu.* module gets loaded."""
    code = (
        "import importlib, sys\n"
        f"for name in {['mvae_tpu_torch'] + _all_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'mvae_tpu'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# every CLI of the port: python -m mvae_tpu_torch.experiments.<family>.<cli>
CLIS = ["experiments.celeba.train", "experiments.celeba.sample",
        "experiments.celeba.loglike"] + [
    f"experiments.{family}.{cli}" for family in ("mnist", "fashionmnist",
                                                 "multimnist", "celeba19",
                                                 "vision")
    for cli in ("train", "sample", "loglike")]


def test_import_rule_covers_the_trainer():
    """The walk above reaches the data loaders, the native host ingest's
    bindings, the image transforms, the models, the driver, the checkpoint
    code, the IWAE, the PNG writer, the measuring tools and every CLI."""
    mods = set(_all_modules())
    for name in ["data.pipeline", "data.celeba", "data.mnist",
                 "data.multimnist", "data.text", "models.mnist",
                 "models.fashionmnist", "models.multimnist",
                 "models.celeba19", "nn.rnn", "core.subsets",
                 "core.loglike", "train.driver", "train.checkpoint",
                 "train.loglike_cli", "utils.cli", "utils.png",
                 "utils.profiling", "ops.convbn",
                 "experiments.multimnist.datasets", "image",
                 "image.transforms", "data.vision", "models.vision",
                 "experiments.vision.setup",
                 "tools.parity_convergence", "serve_http", "data.download",
                 "tools.serve_http_bench", "data.native", "tools.measure",
                 "tools.bench", "tools.bench_families",
                 "tools.roofline_family", "tools.serve_latency"] + CLIS:
        assert f"mvae_tpu_torch.{name}" in mods, name


def test_sources_name_no_jax_and_no_mvae_tpu_module():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b"
                     r"|\bmvae_tpu\.|^\s*(import|from)\s+mvae_tpu\b", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        assert not bad.search(f.read_text()), f


def test_sources_name_no_path_into_the_jax_native_directory():
    """The port builds its host library from its own copy of the C++
    sources (csrc/host/): no file of the package names the repository's
    native/ directory as a path, so nothing of it reads, builds into or
    loads from there."""
    bad = re.compile(r"""(?<![\w.-])native/|["']native["']""")
    files = [f for f in sorted(PKG.rglob("*")) if f.is_file()
             and f.suffix in (".py", ".cc", ".cu", ".cuh", ".h")]
    assert any(f.suffix == ".cc" for f in files)
    for f in files:
        assert not bad.search(f.read_text()), f
    assert bad.search('os.path.join(root, "native")')
    assert bad.search("make -C native/ -s")
    assert not bad.search("csrc/host/mvae_native.cc, data/native.py")


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (CelebaMVAE, MnistMVAE, FashionMnistMVAE, MultiMnistMVAE,
                Celeba19MVAE, VisionMVAE):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(8)
    model = CelebaMVAE(8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_step(model, MASKS, LAMBDAS)
    for make in (make_train_step, make_multi_train_step):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(model, MASKS, LAMBDAS, lr=1e-4, generator=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Sampler(model)
    path = tmp_path / "m.pth.tar"
    torch.save({"state_dict": model.state_dict(), "n_latents": 8}, path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_reference_checkpoint(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Sampler.from_checkpoint(path)
    assert Sampler.from_checkpoint(path, device="cpu").model.n_latents == 8
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model_checkpoint(path, CelebaMVAE)
    assert load_model_checkpoint(path, CelebaMVAE, device="cpu")[
        0].n_latents == 8


@pytest.mark.parametrize("cli", [c for c in CLIS if not c.endswith("train")])
def test_sample_and_loglike_clis_raise_without_cuda(monkeypatch, tmp_path,
                                                    cli):
    """The sample and loglike CLIs run on the card unless --device cpu:
    without one they raise before they read the checkpoint."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    main = importlib.import_module(f"mvae_tpu_torch.{cli}").main
    missing = str(tmp_path / "missing.pth.tar")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([missing, "--data-dir", str(tmp_path)])
    with pytest.raises(FileNotFoundError):
        main([missing, "--device", "cpu", "--data-dir", str(tmp_path)])


def test_cpu_resolution_sets_up_the_vector_math_on_one_thread(monkeypatch):
    """Resolving to the CPU runs warm_cpu_math once: one exp on one
    intra-op thread, the thread count restored after, so a process's first
    multithreaded exp does not meet MKL's first-call race."""
    from mvae_tpu_torch import device as dev
    seen = []
    real_exp = torch.exp
    monkeypatch.setattr(torch, "exp", lambda x: seen.append(
        torch.get_num_threads()) or real_exp(x))
    threads = torch.get_num_threads()
    dev.warm_cpu_math.__wrapped__()
    assert seen == [1] and torch.get_num_threads() == threads
    dev.warm_cpu_math.cache_clear()
    assert dev.resolve_device("cpu") == torch.device("cpu")
    assert dev.resolve_device("cpu") == torch.device("cpu")
    assert seen == [1, 1] and dev.warm_cpu_math.cache_info().hits == 1


def test_train_cli_raises_without_cuda_unless_asked_for_cpu(monkeypatch,
                                                           capsys, tmp_path):
    """The CLI resolves its device before it loads data: on a host without
    a card it raises unless --device cpu; it takes --no-device-data (host
    streaming) and the four multi-process flags, refuses before any
    rendezvous a model axis across nodes (a batch the processes do not
    divide, with fewer of them on this node: the JAX package refuses
    tensor parallelism across hosts) and a start without a rank, and
    refuses the JAX CLI's --cuda, which would do nothing here; it takes
    --exact-decode (PIL for real images)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loads = []
    monkeypatch.setattr(celeba_cli, "load_celeba",
                        lambda *a, **k: loads.append(a) or 1 / 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        celeba_cli.main(["--out-dir", str(tmp_path)])
    assert loads == []
    with pytest.raises(ZeroDivisionError):
        celeba_cli.main(["--device", "cpu", "--out-dir", str(tmp_path)])
    assert len(loads) == 1
    with pytest.raises(ZeroDivisionError):
        celeba_cli.main(["--device", "cpu", "--no-device-data",
                         "--out-dir", str(tmp_path)])
    assert len(loads) == 2 and capsys.readouterr().err == ""
    assert parse_train_args(celeba_cli.parser(),
                            ["--no-device-data"]).no_device_data
    args = parse_train_args(celeba_cli.parser(), [
        "--distributed", "--coordinator", "127.0.0.1:1", "--process-id", "1",
        "--n-processes", "3"])
    assert (args.distributed, args.coordinator, args.process_id,
            args.n_processes) == (True, "127.0.0.1:1", 1, 3)
    for env in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="multi-node runs ship "
                       "data-parallel only"):
        celeba_cli.main(["--device", "cpu", "--coordinator", "127.0.0.1:1",
                         "--process-id", "0", "--n-processes", "3"])
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    for flag in (["--distributed"], ["--coordinator", "localhost:1"]):
        with pytest.raises(SystemExit, match="--process-id i"):
            celeba_cli.main(["--device", "cpu"] + flag)
    assert len(loads) == 2 and not torch.distributed.is_initialized()
    with pytest.raises(SystemExit):
        celeba_cli.main(["--device", "cpu", "--cuda"])
    assert "unrecognized arguments" in capsys.readouterr().err
    with pytest.raises(ZeroDivisionError):
        celeba_cli.main(["--device", "cpu", "--exact-decode",
                         "--out-dir", str(tmp_path)])
    assert len(loads) == 3 and capsys.readouterr().err == ""


@pytest.mark.parametrize("family,loader", [("celeba", "load_celeba"),
                                           ("celeba19", "load_celeba"),
                                           ("vision", "load_celeb_vision")])
def test_exact_decode_reaches_the_celeba_loaders(monkeypatch, tmp_path,
                                                 family, loader):
    """--exact-decode goes to the train and val loaders of the CelebA,
    celeba19 and vision train CLIs (the JAX CLIs' wiring); without it
    they ask for the native decode."""
    import importlib
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    cli = importlib.import_module(f"mvae_tpu_torch.experiments.{family}.train")
    seen = []

    def load(data_dir, partition, **kw):
        seen.append((partition, kw["exact_decode"]))
        if len(seen) % 2 == 0:
            raise ZeroDivisionError
    monkeypatch.setattr(cli, loader, load)
    for flags, exact in (([], False), (["--exact-decode"], True)):
        with pytest.raises(ZeroDivisionError):
            cli.main(["--device", "cpu", "--out-dir", str(tmp_path)] + flags)
        assert seen[-2:] == [("train", exact), ("val", exact)]


@pytest.mark.parametrize("family,loader", [("multimnist", "load_multimnist"),
                                           ("celeba19", "load_celeba"),
                                           ("vision", "load_celeb_vision")])
def test_family_train_clis_raise_without_cuda_unless_asked_for_cpu(
        monkeypatch, tmp_path, family, loader):
    """The MultiMNIST, celeba19 and vision train CLIs resolve their device
    before they load data, as the CelebA one does."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    cli = importlib.import_module(f"mvae_tpu_torch.experiments.{family}.train")
    loads = []
    monkeypatch.setattr(cli, loader, lambda *a, **k: loads.append(a) or 1 / 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--out-dir", str(tmp_path)])
    assert loads == []
    with pytest.raises(ZeroDivisionError):
        cli.main(["--device", "cpu", "--out-dir", str(tmp_path)])
    assert len(loads) == 1


def test_convergence_runner_raises_without_cuda_unless_asked_for_cpu(
        monkeypatch, tmp_path):
    """The convergence runner (tools/parity_convergence.py) runs on the
    card unless --device cpu: without one it raises before it builds the
    data or trains; run_row does the same for device=None."""
    import mvae_tpu_torch.tools.parity_convergence as pc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loads = []
    monkeypatch.setattr(pc, "family_data",
                        lambda *a, **k: loads.append(a) or 1 / 0)
    out = str(tmp_path / "rows.json")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pc.main(["--family", "celeba", "--out", out])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pc.run_row("celeba")
    assert loads == []
    with pytest.raises(ZeroDivisionError):
        pc.main(["--family", "celeba", "--device", "cpu", "--bf16",
                 "--out", out])
    assert len(loads) == 1 and not (tmp_path / "rows.json").exists()


def test_serving_front_raises_without_cuda_unless_asked_for_cpu(
        monkeypatch, tmp_path):
    """The HTTP front's main and its load generator run on the card unless
    --device cpu: without one they raise before they read the checkpoint
    or build a model."""
    import mvae_tpu_torch.serve_http as serve_http
    import mvae_tpu_torch.tools.serve_http_bench as bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing.pth.tar")
    argv = ["--checkpoint", missing, "--family", "mnist"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_http.main(argv)
    with pytest.raises(FileNotFoundError):
        serve_http.main(argv + ["--device", "cpu"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([missing])
    with pytest.raises(FileNotFoundError):
        bench.main([missing, "--device", "cpu"])


def test_measuring_tools_raise_without_cuda_unless_asked_for_cpu(
        monkeypatch, tmp_path):
    """The measuring tools (tools/bench.py, bench_families.py,
    roofline_family.py, serve_latency.py) run on the card unless --device
    cpu: without one they raise before they build a model or read a
    checkpoint."""
    from mvae_tpu_torch.tools import (
        bench, bench_families, roofline_family, serve_latency)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(bench, "Ours", lambda *a: built.append(a) or 1 / 0)
    monkeypatch.setattr(bench_families, "family_spec",
                        lambda *a, **k: built.append(a) or 1 / 0)
    missing = str(tmp_path / "missing.pth.tar")
    runs = ((bench.main, [], ZeroDivisionError),
            (bench_families.main, [], ZeroDivisionError),
            (roofline_family.main, ["--family", "celeba"],
             ZeroDivisionError),
            (serve_latency.main, [missing, "--model", "celeba"],
             FileNotFoundError))
    for main, argv, _ in runs:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    assert built == []
    for main, argv, err in runs:
        with pytest.raises(err):
            main(argv + ["--device", "cpu"])
    assert len(built) == 3


def test_train_mode_is_refused_until_ported():
    """Train mode is ported; what it still refuses is to run without its
    noise: the port draws no random numbers inside the model or the
    engine, so a train-mode forward without the dropout keep-mask, or a
    train-mode ELBO without (eps, keep_mask), raises, as does an ELBO
    whose `train` disagrees with the model's mode."""
    model = CelebaMVAE(8, device="cpu")
    assert not model.training
    model.train()
    batch = {"image": torch.zeros(2, 64, 64, 3), "attrs": torch.zeros(2, 18)}
    with pytest.raises(ValueError, match="keep-mask"):
        model.encode(batch)
    masks, lambdas = torch.tensor(MASKS), torch.tensor(LAMBDAS)
    with pytest.raises(ValueError, match="noise"):
        multi_term_elbo(model, batch, masks, lambdas, train=True)
    with pytest.raises(ValueError, match="train mode"):
        multi_term_elbo(model, batch, masks, lambdas, train=False)
    mu, _, moments = model.encode(
        batch, torch.ones(model.keep_mask_shape(2), dtype=torch.bool))
    assert mu.shape == (2, 2, 8) and len(moments["image"]) == 3
