"""The port's convergence runner (mvae_tpu_torch/tools/parity_convergence.py)
against the JAX package's scripts and rows, on the CPU, for each of the six
families: the protocols are the JAX rows' own, the data functions give the
JAX generators' arrays (vision's derived modalities within the derive
tolerance of tests/test_torch_port_vision.py), the scoring at transplanted
JAX weights equals JAX's eval step and IWAE fed the same draws, a cut
protocol writes a whole row beside an existing one and leaves
PARITY_convergence.json as it was, and the gate on hand-made rows.

The rows themselves come from the card (README.md); a cut protocol here is
two epochs of two batches of a few rows and K <= 5 importance samples.
"""

import hashlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.core.loglike import iwae_log_marginal as jax_iwae
from mvae_tpu.data import vision as jax_vision
from mvae_tpu.data.celeba import synthetic_celeba as jax_synthetic_celeba
from mvae_tpu.data.mnist import synthetic_mnist as jax_synthetic_mnist
from mvae_tpu.data.multimnist import load_multimnist as jax_load_multimnist
from mvae_tpu.models import model_ctor as jax_model_ctor
from mvae_tpu.train.loop import make_eval_step as jax_make_eval_step

import mvae_tpu_torch.tools.parity_convergence as pc
from mvae_tpu_torch.utils.weights import state_dict_from_jax

from tests.test_torch_port_loglike import jax_eps
from tests.test_torch_port_modules import _randomize_bn
from tests.test_torch_port_vision import (  # noqa: F401 (a fixture)
    ARITH_TOL, _held_but_ties, _jax_canny_parts, _ties, one_intra_op_thread)

FAMILIES = sorted(pc.PROTOCOLS)
L = 8
BN_FAMILIES = ("celeba", "celeba19", "multimnist", "vision")


def cut(family, batch=4):
    """The family's protocol cut to two batches a train epoch, two epochs,
    two full test batches and a ragged tail, two IWAE batches."""
    p = dict(pc.PROTOCOLS[family])
    p.update(n_latents=L, batch_size=batch, epochs=2, n_train=2 * batch,
             n_test=2 * batch + 2, iwae_examples=6, iwae_batch=3)
    return p


def q8(x):
    """scripts/parity_extra.py:_q8, written out here."""
    return (np.round(x * 255.0) / 255.0).astype(np.float32)


@pytest.fixture(autouse=True)
def tf32_flags(monkeypatch):
    """A row makes cuDNN deterministic and an f32 row turns TF32 off, for
    the process: restore the flags."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic",
                        torch.backends.cudnn.deterministic)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark",
                        torch.backends.cudnn.benchmark)


# --------------------------------------------------------------------------
# (a) the protocols, (b) the data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_protocol_is_the_jax_rows_own(family):
    with open(pc.JAX_ROWS) as f:
        rows = json.load(f)
    assert pc.PROTOCOLS[family] == rows[family]["protocol"]
    for seed in pc.SEEDS:
        assert rows[pc.row_key(family, seed)]["protocol"] == \
            pc.PROTOCOLS[family]
    assert pc.JAX_BF16_ROW[family] in rows


def jax_data(family, p):
    """What scripts/parity_*.py's data functions build, from the JAX
    package's generators (their `_cached` writes under trained_models/, so
    the test builds the arrays itself)."""
    if family in ("mnist", "fashionmnist"):
        s = 0 if family == "mnist" else 2
        xtr, ytr = jax_synthetic_mnist(p["n_train"], seed=s)
        xte, yte = jax_synthetic_mnist(p["n_test"], seed=s + 1)
        if family == "mnist":
            xtr, xte = xtr.reshape(-1, 784), xte.reshape(-1, 784)
        else:
            xtr, xte = (q8(x.reshape(-1, 28, 28, 1)) for x in (xtr, xte))
        return ({"image": xtr, "text": ytr.astype(np.int32)},
                {"image": xte, "text": yte.astype(np.int32)})
    if family in ("celeba", "celeba19"):
        snap = q8 if family == "celeba19" else (lambda x: x)
        return tuple({"image": snap(a["image"]), "attrs": a["attrs"]}
                     for a in (jax_synthetic_celeba(n, seed=s).arrays
                               for n, s in ((p["n_train"], 0),
                                            (p["n_test"], 1))))
    if family == "multimnist":
        root = str(pc.MULTIMNIST_DIR)
        tr = jax_load_multimnist(root, train=True, generate_n=p["n_train"])
        te = jax_load_multimnist(root, train=False)
        return tuple({"image": ds.arrays["image"][:n],
                      "text": ds.arrays["text"][:n].astype(np.int32)}
                     for ds, n in ((tr, p["n_train"]), (te, p["n_test"])))
    raise ValueError(family)


@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "vision"])
def test_data_is_the_jax_generators_bit_for_bit(family):
    """The protocol's whole train and test sets, array for array."""
    p = pc.PROTOCOLS[family]
    got = pc.family_data(family, p, device="cpu")
    want = jax_data(family, p)
    for g, w in zip(got, want):
        assert sorted(g.arrays) == sorted(w)
        for k, v in w.items():
            assert g.arrays[k].dtype == v.dtype, (k, g.arrays[k].dtype)
            np.testing.assert_array_equal(g.arrays[k], v, err_msg=k)
    assert len(got[0]) == p["n_train"] and len(got[1]) == p["n_test"]


def test_vision_data_is_jax_derive_within_its_tolerance():
    """vision's six modalities, derived on the CPU, snapped to the uint8
    grid, against JAX's derive_modalities then q8, on a cut protocol: the
    image and the masks bit for bit; gray, obscured and watermark equal but
    where JAX's value lies within the derive tolerance (ARITH_TOL) of a
    rounding boundary of the grid, and there one step apart; the edges
    equal but at Canny's ties and what hysteresis carries from them."""
    p = dict(pc.PROTOCOLS["vision"], n_train=5, n_test=3)
    got = pc.family_data("vision", p, device="cpu")
    for ds, (n, seed) in zip(got, ((5, 0), (3, 1))):
        rgb = jax_synthetic_celeba(n, seed=seed).arrays["image"]
        want = jax_vision.derive_modalities(rgb, seed=seed)
        assert sorted(ds.arrays) == sorted(pc.VISION_MODALITIES)
        for k in ("image", "mask"):
            np.testing.assert_array_equal(ds.arrays[k], q8(want[k]),
                                          err_msg=k)
        for k in ("gray", "obscured", "watermark"):
            w = want[k].astype(np.float64) * 255.0
            tol = 255.0 * (ARITH_TOL["atol"] + ARITH_TOL["rtol"]
                           * np.abs(want[k]))
            boundary = np.abs(w - np.floor(w) - 0.5) <= tol
            diff = ds.arrays[k] != q8(want[k])
            assert not (diff & ~boundary).any(), k
            assert np.abs(ds.arrays[k] - q8(want[k])).max() <= 1 / 255 + 1e-7
        mag, gy, gx, keep, lo, hi = _jax_canny_parts(rgb, "absolute")
        _held_but_ties(ds.arrays["edge"][..., 0], want["edge"][..., 0],
                       _ties(mag, gy, gx, lo, hi), keep & (mag >= lo), "edge")


def test_multimnist_data_is_read_only(monkeypatch, tmp_path):
    """Without the repository's shards family_data raises; it generates
    none."""
    monkeypatch.setattr(pc, "MULTIMNIST_DIR", tmp_path / "none")
    with pytest.raises(FileNotFoundError, match="repository's set"):
        pc.family_data("multimnist", cut("multimnist"), device="cpu")
    assert not (tmp_path / "none").exists()


# --------------------------------------------------------------------------
# (c) the scoring at transplanted JAX weights
# --------------------------------------------------------------------------

def transplant(family):
    jm = jax_model_ctor(family)(L)
    params, state = jm.init(jax.random.key(3))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    if family in BN_FAMILIES:
        rng = np.random.default_rng(4)
        params, state = _randomize_bn(params, rng), _randomize_bn(state, rng)
    model = pc.MODELS[family](L, None, device="cpu")
    sd = state_dict_from_jax(family, params, state)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                          strict=True)
    return jm, params, state, model


@pytest.mark.parametrize("family", FAMILIES)
def test_scoring_matches_jax_at_transplanted_weights(family):
    """The test ELBO (full batches, the eval terms of the family's
    run_ours*) and the IWAE of log p(image) with the joint proposal, JAX's
    draws fed to both sides: f32, rtol 1e-4."""
    p = cut(family)
    jm, params, state, model = transplant(family)
    test = pc.family_data(family, p, device="cpu")[1]
    got = pc.eval_elbo(model, family, p, test, torch.device("cpu"))
    masks, lambdas = pc.family_terms(family, p)["eval"]
    ev = jax_make_eval_step(jm, masks, lambdas)
    b, n = p["batch_size"], len(test)
    want = np.mean([float(ev(params, state, {
        k: jnp.asarray(v[lo:lo + b]) for k, v in test.arrays.items()})[0])
        for lo in range(0, n - n % b, b)])
    np.testing.assert_allclose(got, want, rtol=1e-4)

    k = 3
    keys = {}

    def eps(i, k_, rows, d):
        keys[i] = jax.random.key(pc.IWAE_SEED[family] + i)
        return torch.from_numpy(jax_eps(keys[i], k_, rows, d))

    got = pc.iwae(model, family, p, test, k, torch.device("cpu"), eps=eps)
    vals = []
    for i, lo in enumerate(range(0, p["iwae_examples"], p["iwae_batch"])):
        batch = {kk: jnp.asarray(v[lo:lo + p["iwae_batch"]])
                 for kk, v in test.arrays.items()}
        vals.append(np.asarray(jax_iwae(
            jm, params, state, batch, jnp.ones(len(model.modalities)),
            ("image",), keys[i], k)))
    assert sorted(keys) == [0, 1]
    np.testing.assert_allclose(got, np.concatenate(vals).mean(), rtol=1e-4)


def test_iwae_draws_come_from_the_seeded_generator():
    """Without eps, batch i draws from torch.Generator seeded
    IWAE_SEED + i: two calls agree bit for bit, another K does not."""
    p = cut("mnist")
    model = pc.build_model("mnist", p, False, 0, torch.device("cpu"))
    test = pc.family_data("mnist", p, device="cpu")[1]
    cpu = torch.device("cpu")
    a = pc.iwae(model, "mnist", p, test, 2, cpu)
    b = pc.iwae(model, "mnist", p, test, 2, cpu)
    seen = []

    def eps(i, k, rows, d):
        seen.append(i)
        gen = torch.Generator().manual_seed(pc.IWAE_SEED["mnist"] + i)
        return torch.randn((k, rows, d), generator=gen)

    c = pc.iwae(model, "mnist", p, test, 2, cpu, eps=eps)
    assert a == b == c and seen == [0, 1]
    assert pc.iwae(model, "mnist", p, test, 3, cpu) != a


# --------------------------------------------------------------------------
# (d) a cut protocol end to end
# --------------------------------------------------------------------------

def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("family,bf16", [(f, False) for f in FAMILIES]
                         + [("celeba19", True), ("mnist", True)])
def test_cut_protocol_writes_a_whole_row(monkeypatch, tmp_path, capsys,
                                         family, bf16):
    """--device cpu on a cut protocol: the row holds every key with finite
    values, merges beside a key already in the file, and leaves the JAX
    rows byte for byte as they were."""
    monkeypatch.setitem(pc.PROTOCOLS, family, cut(family, batch=3))
    monkeypatch.setattr(pc, "IWAE_K", {"iwae_100": 2, "iwae_500": 5})
    before = _digest(pc.JAX_ROWS)
    out = tmp_path / "rows.json"
    out.write_text(json.dumps({"other@seed1": {"keep": 1}}))
    argv = ["--family", family, "--device", "cpu", "--seed", "1",
            "--out", str(out), "--work-dir", str(tmp_path / "w")]
    row = pc.main(argv + (["--bf16"] if bf16 else []))
    rows = json.loads(out.read_text())
    key = pc.row_key(family, 1, bf16)
    assert rows["other@seed1"] == {"keep": 1} and rows[key] == row
    assert sorted(row) == ["code", "gap_to_jax_row", "gap_to_mean",
                           "jax_mean", "jax_spread", "port", "precision",
                           "protocol", "seed", "within"]
    assert row["code"] == pc.code_digest()
    assert row["protocol"] == cut(family, batch=3)
    assert row["precision"] == ("bf16" if bf16 else "f32") and row["seed"] == 1
    assert sorted(row["port"]) == sorted(pc.METRICS + (
        "train_seconds", "steps", "steps_per_second", "card"))
    assert row["port"]["card"] == "cpu" and row["port"]["steps"] == 4
    for m in pc.METRICS:
        for part in ("port", "jax_mean", "jax_spread", "gap_to_mean",
                     "gap_to_jax_row"):
            assert math.isfinite(row[part][m]), (part, m)
        assert row["within"][m] == (row["gap_to_mean"][m]
                                    <= row["jax_spread"][m])
    assert row["port"]["test_elbo"] > 0 > row["port"]["iwae_500"]
    assert row["gap_to_jax_row"]["row"] == (
        pc.JAX_BF16_ROW[family] if bf16 else f"{family}@seed1")
    assert (tmp_path / "w" / "checkpoint.pth.tar").exists()
    assert _digest(pc.JAX_ROWS) == before
    assert f"[parity] {key}: " in capsys.readouterr().out


@pytest.mark.parametrize("bf16", [False, True])
def test_run_row_makes_cudnn_deterministic_before_the_data(monkeypatch,
                                                           bf16):
    """run_row sets cudnn.deterministic and clears cudnn.benchmark before
    it builds the data, in both precisions, so that a rerun of a row on
    the card trains bit for bit alike; f32 also turns TF32 off."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []

    def stop(*a, **k):
        cudnn = torch.backends.cudnn
        seen.append((cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32))
        raise InterruptedError

    monkeypatch.setattr(pc, "family_data", stop)
    with pytest.raises(InterruptedError):
        pc.run_row("fashionmnist", bf16=bf16, device="cpu")
    assert seen == [(True, False, bf16)]


def test_runner_refuses_to_write_the_jax_rows(tmp_path):
    with pytest.raises(SystemExit):
        pc.main(["--family", "mnist", "--device", "cpu",
                 "--out", str(pc.JAX_ROWS)])


# --------------------------------------------------------------------------
# (e) the gate
# --------------------------------------------------------------------------

JAX_MEAN = {"test_elbo": 100.0, "iwae_100": -50.0, "iwae_500": -40.0}
SPREAD = {"test_elbo": 0.02, "iwae_100": 0.01, "iwae_500": 0.01}


def scores(elbo, i100, i500):
    return {"test_elbo": elbo, "iwae_100": i100, "iwae_500": i500}


def test_gate_passes_on_seed_zero():
    g = pc.gate({0: scores(101.9, -50.4, -39.7)}, JAX_MEAN, SPREAD)
    assert g["verdict"] == "pass" and g["by"] == "seed 0"
    assert g["gap_seed0"]["test_elbo"] == pytest.approx(0.019)
    assert g["seed0_within"]


def test_gate_seed_zero_pass_overruled_by_the_three_seed_mean():
    """Where seeds 1 and 2 are in, their mean with seed 0 decides: a seed 0
    within s does not pass a pair whose three-seed mean misses."""
    runs = {0: scores(101.9, -50.4, -39.7), 1: scores(103.0, -50.0, -40.0)}
    assert pc.gate(runs, JAX_MEAN, SPREAD)["verdict"] == "pass"
    runs[2] = scores(103.4, -50.0, -40.0)       # elbo mean 2.77% off
    g = pc.gate(runs, JAX_MEAN, SPREAD)
    assert g["verdict"] == "fail" and g["by"] is None and g["seed0_within"]
    assert g["gap_three_seed_mean"]["test_elbo"] == pytest.approx(
        (101.9 + 103.0 + 103.4) / 300 - 1)


def test_gate_miss_waits_for_three_seeds_then_fails():
    runs = {0: scores(103.0, -50.0, -40.0)}     # elbo 3% off, s = 2%
    assert pc.gate(runs, JAX_MEAN, SPREAD)["verdict"] == "pending"
    runs[1] = scores(102.5, -50.0, -40.0)
    assert pc.gate(runs, JAX_MEAN, SPREAD)["verdict"] == "pending"
    runs[2] = scores(102.6, -50.0, -40.0)
    g = pc.gate(runs, JAX_MEAN, SPREAD)
    assert g["verdict"] == "fail" and g["by"] is None
    assert g["gap_three_seed_mean"]["test_elbo"] == pytest.approx(0.027)


def test_gate_miss_rescued_by_the_three_seed_mean():
    runs = {0: scores(100.0, -50.8, -40.0),     # iwae_100 1.6% off
            1: scores(99.0, -49.6, -40.2), 2: scores(101.0, -49.9, -39.9)}
    g = pc.gate(runs, JAX_MEAN, SPREAD)
    assert g["verdict"] == "pass" and g["by"] == "three-seed mean"
    assert g["port_mean"]["iwae_100"] == pytest.approx(-50.1)
    assert g["port_spread"]["test_elbo"] == pytest.approx(0.02)
    assert g["port_spread"]["iwae_100"] == pytest.approx(1.2 / 50.1)


def test_yardstick_and_merge_write_the_gate(tmp_path):
    """The JAX spread is (max - min) / |mean| over the three f32 rows (the
    mnist test ELBO's 18.6%); each merge recomputes the gate of the pair
    into its seed-0 row."""
    with open(pc.JAX_ROWS) as f:
        jax_rows = json.load(f)
    mean, spread = pc.jax_yardstick(jax_rows, "mnist")
    elbos = [jax_rows[k]["ours"]["test_elbo"]
             for k in ("mnist", "mnist@seed1", "mnist@seed2")]
    assert mean["test_elbo"] == pytest.approx(np.mean(elbos))
    assert spread["test_elbo"] == pytest.approx(0.186, abs=5e-4)
    out = tmp_path / "rows.json"
    far = {m: 3 * v for m, v in mean.items()}
    for seed, port in ((0, far), (1, mean), (2, mean)):
        row = pc.make_row("mnist", pc.PROTOCOLS["mnist"], seed, True, port,
                          jax_rows)
        rows = pc.merge_row(out, pc.row_key("mnist", seed, True), row,
                            jax_rows)
        want = "pending" if seed < 2 else "fail"
        assert rows["mnist@bf16"]["gate"]["verdict"] == want
    assert "gate" not in rows["mnist@seed1@bf16"]
    assert json.loads(out.read_text()) == rows


def test_merge_pools_only_rows_of_the_written_rows_code(tmp_path,
                                                        monkeypatch):
    """A row of other code (another digest of the port's sources) stays in
    the file but out of the gate, listed as stale: seeds 1 and 2 of new
    code beside a seed 0 of old code leave the pair pending."""
    with open(pc.JAX_ROWS) as f:
        jax_rows = json.load(f)
    mean, _ = pc.jax_yardstick(jax_rows, "celeba")
    out = tmp_path / "rows.json"
    for seed, code in ((0, "old"), (1, "new"), (2, "new")):
        monkeypatch.setattr(pc, "code_digest", lambda c=code: c)
        row = pc.make_row("celeba", pc.PROTOCOLS["celeba"], seed, False,
                          mean, jax_rows)
        rows = pc.merge_row(out, pc.row_key("celeba", seed), row, jax_rows)
    g = rows["celeba"]["gate"]
    assert rows["celeba"]["code"] == "old" and rows["celeba@seed2"]["code"] \
        == "new"
    assert g["verdict"] == "pending" and g["seeds"] == [1, 2]
    assert g["code"] == "new" and g["stale"] == ["celeba"]
    monkeypatch.setattr(pc, "code_digest", lambda: "new")
    row = pc.make_row("celeba", pc.PROTOCOLS["celeba"], 0, False, mean,
                      jax_rows)
    g = pc.merge_row(out, "celeba", row, jax_rows)["celeba"]["gate"]
    assert g["verdict"] == "pass" and g["by"] == "three-seed mean"
    assert g["stale"] == []


def test_code_digest_follows_the_port_sources(tmp_path, monkeypatch):
    """code_digest reads every .py, .cu and .cuh file of the package by
    path and bytes: a changed byte, a new source or a renamed one moves
    it; a file of another kind does not."""
    pkg = tmp_path / "mvae_tpu_torch"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "a.py").write_text("x = 1\n")
    (pkg / "csrc" / "k.cu").write_text("// k\n")
    monkeypatch.setattr(pc, "PACKAGE", pkg)
    seen = [pc.code_digest()]
    (pkg / "notes.txt").write_text("not a source")
    assert pc.code_digest() == seen[0]
    (pkg / "a.py").write_text("x = 2\n")
    seen.append(pc.code_digest())
    (pkg / "csrc" / "r.cuh").write_text("// r\n")
    seen.append(pc.code_digest())
    (pkg / "a.py").rename(pkg / "b.py")
    seen.append(pc.code_digest())
    assert len(set(seen)) == 4 and all(len(d) == 16 for d in seen)


# --------------------------------------------------------------------------
# (f) the fault the MNIST rows found: swish's gradient below -88.7
# --------------------------------------------------------------------------

SWISH_X = [-1000.0, -100.0, -91.7, -88.8, -88.6, -50.0, -3.0, -0.5, 0.0,
           0.25, 3.0, 20.0, 91.7, 1000.0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swish_gradient_is_jax_and_finite_where_exp_overflows(dtype):
    """swish's value and gradient at every x, past exp(-x)'s overflow at
    x < -88.7 too, equal jax.grad of x * jax.nn.sigmoid(x) in the same
    dtype (f32 within 1 ulp; bf16 gradients bit for bit above the
    subnormal range): autograd through
    1 / (1 + exp(-x)) gave NaN there (0 * inf), which trained the MNIST
    protocol into NaN on its fourth epoch."""
    from mvae_tpu_torch.nn.layers import swish
    x = torch.tensor(SWISH_X, dtype=getattr(torch, dtype),
                     requires_grad=True)
    y = swish(x)
    g = torch.linspace(-2, 2, len(SWISH_X)).to(x.dtype)
    y.backward(g)
    jx = jnp.asarray(SWISH_X, dtype)
    jy, vjp = jax.vjp(lambda v: v * jax.nn.sigmoid(v), jx)
    (jg,) = vjp(jnp.asarray(g.float().numpy(), dtype))
    assert torch.isfinite(x.grad).all()
    got_y, got_g = y.detach().float().numpy(), x.grad.float().numpy()
    want_y, want_g = (np.asarray(v, np.float32) for v in (jy, jg))
    # atol 1e-30: XLA's CPU flushes subnormals to zero, so where s is
    # subnormal (x near -88.6) JAX's gradient is 0 and the port's ~1e-37
    if dtype == "bfloat16":
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-30)
        np.testing.assert_allclose(got_y, want_y, rtol=8e-3, atol=1e-30)
    else:
        np.testing.assert_allclose(got_g, want_g, rtol=2e-7, atol=1e-30)
        np.testing.assert_allclose(got_y, want_y, rtol=2e-7, atol=1e-30)


def test_mnist_step_past_the_overflow_matches_jax():
    """One MNIST train step (Adam(1e-3), the protocol's lambdas, JAX's
    eps) where 64 of the image decoder's third layer's units sit near
    -100 before their swish: every parameter after the step is finite and
    within 1e-4 of JAX's in relative Frobenius norm."""
    from tests.test_torch_port_families import _jax_eps
    import optax
    from mvae_tpu.train.loop import make_train_step as jax_make_train_step
    from mvae_tpu_torch.train.loop import make_train_step

    jm = jax_model_ctor("mnist")(L)
    params, state = jm.init(jax.random.key(5))
    params = jax.tree_util.tree_map(np.array, params)
    params["image_dec"][2]["b"][:64] = -100.0
    model = pc.MODELS["mnist"](L, None, device="cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           state_dict_from_jax("mnist", params,
                                               state).items()}, strict=True)
    terms = pc.family_terms("mnist", pc.PROTOCOLS["mnist"])["train"]
    rng = np.random.default_rng(6)
    b = 6
    batch = {"image": rng.random((b, 784)).astype(np.float32),
             "text": rng.integers(0, 10, b).astype(np.int32)}
    key = jax.random.key(7)
    tx = optax.adam(1e-3)
    j_params = jax_make_train_step(
        jm, tx, terms["term_masks"], terms["term_lambdas"])(
        jax.tree_util.tree_map(jnp.array, params), state, tx.init(params),
        key, {k: jnp.asarray(v) for k, v in batch.items()}, 0.5)[0]
    step = make_train_step(model, terms["term_masks"], terms["term_lambdas"],
                           lr=1e-3, device="cpu", generator=torch.Generator())
    step({k: torch.from_numpy(v) for k, v in batch.items()}, 0.5,
         noise=(torch.tensor(_jax_eps(key, b)), None))
    want = state_dict_from_jax("mnist", jax.tree_util.tree_map(
        np.asarray, j_params), state)
    for k, v in model.state_dict().items():
        assert torch.isfinite(v).all(), k
        assert np.linalg.norm(v.numpy() - want[k]) <= 1e-4 * np.linalg.norm(
            want[k]), k
