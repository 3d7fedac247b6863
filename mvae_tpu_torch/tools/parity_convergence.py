"""Trained-to-convergence parity of the port against the JAX package's rows
(counterpart of the `_data`, `run_ours*` and `main` functions of
scripts/parity_convergence.py and scripts/parity_extra.py).

    python -m mvae_tpu_torch.tools.parity_convergence --family celeba \
        [--bf16] [--seed N] [--device cpu] [--out PATH] [--work-dir DIR]

Trains one family at one precision on its protocol (the JAX rows' own,
`PROTOCOLS`) through the port's `train/driver.py:run_training`, scores
the final weights (the test ELBO over the test set's full batches, the
IWAE estimate of log p(image) at K = 100 and 500 with the joint
proposal), holds the scores against the JAX package's rows in
PARITY_convergence.json (read as plain JSON, never written) and merges the
row into PARITY_convergence_torch.json (or --out) under
`<family>[@seedN][@bf16]`.

The yardstick of a family is the JAX f32 three-seed spread s = (max -
min) / |mean| over its rows `<family>`, `<family>@seed1` and
`<family>@seed2`; a row is within it where |port - mean| / |mean| <= s.
`gate` decides a family at one precision: the mean of the port's seeds 0,
1 and 2 within s in all three metrics where the file holds all three, else
its seed-0 row within s. Each row carries `code`, a digest of the port's
sources; each write recomputes the gate of the row's family and precision
from the rows of the written row's digest and stores it in the seed-0 row
under "gate" (a row of other code is listed there as stale, never pooled).

Runs on the CUDA card unless --device says otherwise (raises without
one). Before the first step a row makes cuDNN deterministic
(`cudnn.deterministic`, no `cudnn.benchmark`), so a rerun of a row trains
bit for bit alike, in both precisions; f32 also turns TF32 off in cuDNN
and cuBLAS. Neither is restored: one process trains one row.
--bf16 is the family CLI's shipped bf16 mode: bf16 compute, the in-step
decode in bf16, and for celeba19 the image BCE's bf16 math. Checkpoints go
to --work-dir (a temporary directory by default). The data comes from the
port's generators (synthetic MNIST and CelebA from their seeds, vision's
six modalities derived on the device, images snapped to the uint8 grid as
the JAX rows' were) and from data/parity_multimnist, which is only read.
"""

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from mvae_tpu_torch.core.loglike import iwae_log_marginal
from mvae_tpu_torch.core.subsets import (
    celeba19_recon_support, celeba19_static_terms, celeba19_step_terms)
from mvae_tpu_torch.data.celeba import synthetic_celeba
from mvae_tpu_torch.data.mnist import synthetic_mnist
from mvae_tpu_torch.data.multimnist import load_multimnist
from mvae_tpu_torch.data.pipeline import ArrayDataset
from mvae_tpu_torch.data.vision import derive_modalities
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.experiments.celeba19.train import bf16_loss_default
from mvae_tpu_torch.models import FAMILIES as MODELS
from mvae_tpu_torch.models.celeba19 import N_ATTRS
from mvae_tpu_torch.models.vision import MODALITIES as VISION_MODALITIES
from mvae_tpu_torch.models.vision import N_MODALITIES
from mvae_tpu_torch.train.driver import run_training
from mvae_tpu_torch.train.loop import make_eval_step

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = ROOT / "mvae_tpu_torch"
SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cc")
JAX_ROWS = ROOT / "PARITY_convergence.json"
PORT_ROWS = ROOT / "PARITY_convergence_torch.json"
MULTIMNIST_DIR = ROOT / "data" / "parity_multimnist"

# the JAX rows' protocols, PARITY_convergence.json[family]["protocol"]:
# scripts/parity_convergence.py:90-93, 306-309, 536-539 and
# scripts/parity_extra.py:122-125 (FASHION), 340-343 (CELEBA19), 586-588
# (VISION)
PROTOCOLS = {
    "mnist": dict(n_latents=64, batch_size=100, lr=1e-3, epochs=40,
                  annealing_epochs=20, lambda_image=1.0, lambda_text=10.0,
                  n_train=20000, n_test=2000, iwae_examples=1000,
                  iwae_batch=100),
    "fashionmnist": dict(n_latents=64, batch_size=100, lr=1e-3, epochs=12,
                         annealing_epochs=10, lambda_image=1.0,
                         lambda_text=10.0, n_train=10000, n_test=2000,
                         iwae_examples=500, iwae_batch=100),
    "multimnist": dict(n_latents=64, batch_size=100, lr=1e-3, epochs=12,
                       annealing_epochs=6, lambda_image=1.0,
                       lambda_text=10.0, n_train=5000, n_test=1000,
                       iwae_examples=200, iwae_batch=100),
    "celeba": dict(n_latents=100, batch_size=100, lr=1e-4, epochs=12,
                   annealing_epochs=4, lambda_image=1.0, lambda_attrs=10.0,
                   n_train=2000, n_test=500, iwae_examples=200,
                   iwae_batch=100),
    "celeba19": dict(n_latents=100, batch_size=100, lr=1e-4, epochs=8,
                     annealing_epochs=3, lambda_image=1.0,
                     lambda_attrs=10.0, approx_m=1, n_train=2000,
                     n_test=500, iwae_examples=200, iwae_batch=100),
    "vision": dict(n_latents=100, batch_size=50, lr=1e-4, epochs=6,
                   annealing_epochs=2, n_train=1000, n_test=250,
                   iwae_examples=100, iwae_batch=50),
}
# the steps a log line (one dispatch window) in each run_ours*; the
# window does not change what the steps compute
LOG_INTERVAL = {"mnist": 100, "fashionmnist": 50, "multimnist": 50,
                "celeba": 100, "celeba19": 20, "vision": 20}
# the IWAE draws of batch i come from seed IWAE_SEED[family] + i, as
# jax.random.key(IWAE_SEED[family] + i) seeds them in each run_ours*
IWAE_SEED = {"mnist": 100, "celeba": 200, "multimnist": 300,
             "fashionmnist": 400, "celeba19": 500, "vision": 600}
# the IWAE metrics and their samples K
IWAE_K = {"iwae_100": 100, "iwae_500": 500}
METRICS = ("test_elbo", "iwae_100", "iwae_500")
# the JAX row of each family's shipped bf16 mode (celeba19's CLI ships the
# BCE's bf16 math under bf16)
JAX_BF16_ROW = {"mnist": "mnist@bf16@dec",
                "fashionmnist": "fashionmnist@bf16@dec",
                "multimnist": "multimnist@bf16@dec",
                "celeba": "celeba@bf16@dec",
                "celeba19": "celeba19@bf16@dec@bf16loss",
                "vision": "vision@bf16@dec"}
SEEDS = (0, 1, 2)
PAIR_TERMS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]


def q8(x):
    """Images snapped to the uint8 grid (scripts/parity_extra.py:60-63)."""
    return (np.round(x * 255.0) / 255.0).astype(np.float32)


def family_data(family, p, device=None):
    """(train, test) ArrayDatasets of the family's protocol p, as its
    `_data` / `_*_data` builds them. device: where vision derives its
    modalities (None: the CUDA card)."""
    if family == "mnist":
        xtr, ytr = synthetic_mnist(p["n_train"], seed=0)
        xte, yte = synthetic_mnist(p["n_test"], seed=1)
        return (ArrayDataset({"image": xtr.reshape(-1, 784),
                              "text": ytr.astype(np.int32)}),
                ArrayDataset({"image": xte.reshape(-1, 784),
                              "text": yte.astype(np.int32)}))
    if family == "fashionmnist":
        xtr, ytr = synthetic_mnist(p["n_train"], seed=2)
        xte, yte = synthetic_mnist(p["n_test"], seed=3)
        return (ArrayDataset({"image": q8(xtr.reshape(-1, 28, 28, 1)),
                              "text": ytr.astype(np.int32)}),
                ArrayDataset({"image": q8(xte.reshape(-1, 28, 28, 1)),
                              "text": yte.astype(np.int32)}))
    if family in ("celeba", "celeba19"):
        snap = q8 if family == "celeba19" else (lambda x: x)
        out = []
        for n, seed in ((p["n_train"], 0), (p["n_test"], 1)):
            a = synthetic_celeba(n, seed=seed).arrays
            out.append(ArrayDataset({"image": snap(a["image"]),
                                     "attrs": a["attrs"]}))
        return tuple(out)
    if family == "multimnist":
        # read only: the loader would generate shards where none are
        for split in ("training", "test"):
            path = MULTIMNIST_DIR / "multimnist" / f"{split}.npz"
            if not path.exists():
                raise FileNotFoundError(f"{path} is missing: the MultiMNIST "
                                        f"protocol reads the repository's set")
        out = []
        for train, n in ((True, p["n_train"]), (False, p["n_test"])):
            a = load_multimnist(str(MULTIMNIST_DIR), train=train).arrays
            out.append(ArrayDataset({"image": a["image"][:n],
                                     "text": a["text"][:n].astype(np.int32)}))
        return tuple(out)
    if family == "vision":
        out = []
        for n, seed in ((p["n_train"], 0), (p["n_test"], 1)):
            rgb = synthetic_celeba(n, seed=seed).arrays["image"]
            mods = derive_modalities(rgb, seed=seed, device=device)
            out.append(ArrayDataset({k: q8(mods[k])
                                     for k in VISION_MODALITIES}))
        return tuple(out)
    raise ValueError(f"unknown family {family!r}")


def family_terms(family, p):
    """The family's ELBO terms as its run_ours* passes them: `train`, the
    keyword arguments of run_training besides the model and data
    (term_masks, term_lambdas and the rest), and `eval`, the scoring
    eval step's (masks, lambdas)."""
    if family in ("mnist", "fashionmnist", "multimnist", "celeba"):
        attr = "attrs" if family == "celeba" else "text"
        lambdas = [[p["lambda_image"], p[f"lambda_{attr}"]]] * 3
        # celeba keeps the train lambdas for its eval
        evl = lambdas if family == "celeba" else [[1.0, 1.0]] * 3
        train = dict(term_masks=PAIR_TERMS, term_lambdas=lambdas)
        if family != "celeba":
            train["eval_term_lambdas"] = evl
        return {"train": train, "eval": (PAIR_TERMS, evl)}
    if family == "celeba19":
        static_m, static_l = celeba19_static_terms(
            N_ATTRS, p["lambda_image"], p["lambda_attrs"])

        def make_masks(rng):
            return celeba19_step_terms(rng, p["approx_m"], N_ATTRS,
                                       p["lambda_image"], p["lambda_attrs"])

        ones = np.ones((1, 1 + N_ATTRS), np.float32)
        return {"train": dict(
            term_masks=static_m, term_lambdas=static_l, make_masks=make_masks,
            eval_term_masks=ones, eval_term_lambdas=ones,
            recon_support=celeba19_recon_support(p["approx_m"], N_ATTRS)),
            "eval": (ones, ones)}
    if family == "vision":
        n = N_MODALITIES
        joint = np.ones((1, n), np.float32)
        sixth = np.full((1, n), 1.0 / n, np.float32)
        return {"train": dict(
            term_masks=np.concatenate([joint, np.eye(n, dtype=np.float32)]),
            term_lambdas=np.full((n + 1, n), 1.0 / n, np.float32),
            recon_masks=np.ones((n + 1, n), np.float32),
            eval_term_masks=joint, eval_term_lambdas=sixth),
            "eval": (joint, sixth)}
    raise ValueError(f"unknown family {family!r}")


def build_model(family, p, bf16, seed, device):
    """The family's model at the width of protocol p, its weights from seed
    (as the train CLIs make them), in the shipped bf16 mode or in f32."""
    kw = {}
    if family == "celeba19":
        kw["bf16_loss"] = bf16_loss_default(bf16, False)
    return MODELS[family](p["n_latents"], torch.bfloat16 if bf16 else None,
                          device=device,
                          generator=torch.Generator().manual_seed(seed), **kw)


def train(model, family, p, data, seed, device, work_dir):
    """run_training over the protocol's epochs; returns its wall seconds
    (the per-epoch eval and checkpoints included, as the JAX rows'
    train_seconds are)."""
    args = SimpleNamespace(
        batch_size=p["batch_size"], lr=p["lr"], epochs=p["epochs"],
        annealing_epochs=p["annealing_epochs"],
        log_interval=LOG_INTERVAL[family], seed=seed, resume=None,
        profile_dir=None, no_device_data=False)
    t0 = time.perf_counter()
    run_training(model, data[0], data[1], args, out_dir=str(work_dir),
                 device=device, meta={"model": family,
                                      "n_latents": p["n_latents"]},
                 **family_terms(family, p)["train"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _rows(test, lo, hi, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi])).to(device)
            for k, v in test.arrays.items()}


def eval_elbo(model, family, p, test, device):
    """The scoring eval step's mean loss over the test set's full batches,
    each weighted by its rows (the ragged tail left out)."""
    masks, lambdas = family_terms(family, p)["eval"]
    step = make_eval_step(model, masks, lambdas, device=device)
    b, n = p["batch_size"], len(test)
    losses = [step(_rows(test, lo, lo + b, device))[0]
              for lo in range(0, n - n % b, b)]
    return float(torch.stack(losses).double().mean())


def iwae(model, family, p, test, k, device, eps=None):
    """The mean IWAE estimate of log p(image) at k samples over the first
    iwae_examples test rows in batches of iwae_batch, the proposal q
    conditioned on every modality. eps: fn(batch index, k, rows, latents)
    -> draws, in place of the seeded generator's (tests feed JAX's)."""
    proposal = [1.0] * len(model.modalities)
    vals = []
    for i, lo in enumerate(range(0, p["iwae_examples"], p["iwae_batch"])):
        batch = _rows(test, lo, lo + p["iwae_batch"], device)
        rows = len(next(iter(batch.values())))
        if eps is None:
            gen = torch.Generator(device=device).manual_seed(
                IWAE_SEED[family] + i)
            draws = torch.randn((k, rows, model.n_latents), generator=gen,
                                device=device)
        else:
            draws = torch.as_tensor(eps(i, k, rows, model.n_latents),
                                    device=device)
        vals.append(iwae_log_marginal(model, batch, proposal, ("image",), k,
                                      eps=draws).cpu())
    return float(torch.cat(vals).double().mean())


def score(model, family, p, test, device, eps=None):
    """{test_elbo, iwae_100, iwae_500} of the trained model."""
    out = {"test_elbo": eval_elbo(model, family, p, test, device)}
    for name, k in IWAE_K.items():
        out[name] = iwae(model, family, p, test, k, device, eps)
    return out


def card_name(device):
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def row_key(family, seed=0, bf16=False):
    return family + (f"@seed{seed}" if seed else "") + ("@bf16" if bf16
                                                        else "")


def _gaps(got, want):
    return {m: abs(got[m] - want[m]) / abs(want[m]) for m in METRICS}


def jax_yardstick(jax_rows, family):
    """(mean, spread) of the JAX f32 rows <family>, @seed1, @seed2, per
    metric: spread = (max - min) / |mean|."""
    runs = [jax_rows[row_key(family, s)]["ours"] for s in SEEDS]
    mean = {m: float(np.mean([r[m] for r in runs])) for m in METRICS}
    spread = {m: (max(r[m] for r in runs) - min(r[m] for r in runs))
              / abs(mean[m]) for m in METRICS}
    return mean, spread


def gate(port_runs, jax_mean, jax_spread):
    """Whether a family at one precision passes. port_runs: its scores by
    seed, {seed: {metric: value}}. Where seeds 0, 1 and 2 are all at hand,
    their mean decides: it passes when the mean is within the JAX spread
    of the JAX mean in all three metrics (the port's own three-seed spread
    beside it), whatever seed 0 alone reads. Until then it passes when seed
    0 is within in all three metrics, and a miss is "pending"."""
    out = {"seeds": sorted(port_runs)}
    if 0 in port_runs:
        gap = _gaps(port_runs[0], jax_mean)
        out.update(gap_seed0=gap, seed0_within=all(
            gap[m] <= jax_spread[m] for m in METRICS))
    if not all(s in port_runs for s in SEEDS):
        if out.get("seed0_within"):
            return dict(out, verdict="pass", by="seed 0")
        return dict(out, verdict="pending", by=None)
    runs = [port_runs[s] for s in SEEDS]
    mean = {m: float(np.mean([r[m] for r in runs])) for m in METRICS}
    gap = _gaps(mean, jax_mean)
    out.update(port_mean=mean, gap_three_seed_mean=gap, port_spread={
        m: (max(r[m] for r in runs) - min(r[m] for r in runs)) / abs(mean[m])
        for m in METRICS})
    ok = all(gap[m] <= jax_spread[m] for m in METRICS)
    return dict(out, verdict="pass" if ok else "fail",
                by="three-seed mean" if ok else None)


def code_digest():
    """A digest of the port's sources (every .py, .cu, .cuh and .cc file
    under mvae_tpu_torch/, by relative path and bytes): the code a row
    came from."""
    h = hashlib.sha256()
    for f in sorted(PACKAGE.rglob("*")):
        if f.suffix in SOURCE_SUFFIXES and "__pycache__" not in f.parts:
            h.update(f.relative_to(PACKAGE).as_posix().encode() + b"\0")
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def make_row(family, p, seed, bf16, port, jax_rows):
    """A row of PARITY_convergence_torch.json: the port's scores beside the
    JAX yardstick and the gap to the matching JAX row, with the digest of
    the code that produced it."""
    mean, spread = jax_yardstick(jax_rows, family)
    gap = _gaps(port, mean)
    ref = JAX_BF16_ROW[family] if bf16 else row_key(family, seed)
    row = {"protocol": p, "code": code_digest(),
           "precision": "bf16" if bf16 else "f32", "seed": seed,
           "port": port, "jax_mean": mean, "jax_spread": spread,
           "gap_to_mean": gap,
           "within": {m: gap[m] <= spread[m] for m in METRICS}}
    if ref in jax_rows:
        row["gap_to_jax_row"] = dict(
            _gaps(port, jax_rows[ref]["ours"]), row=ref)
    return row


def _load(path):
    path = Path(path)
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)


def merge_row(path, key, row, jax_rows):
    """Write `row` under `key` into the file at path: reload it first so
    that a concurrent write of another key survives, then recompute the
    gate of the row's family and precision into its seed-0 row from the
    rows of `row`'s code (those of other code listed as stale)."""
    rows = _load(path)
    rows[key] = row
    family, bf16 = key.split("@")[0], row["precision"] == "bf16"
    keys = {s: row_key(family, s, bf16) for s in SEEDS
            if row_key(family, s, bf16) in rows}
    runs = {s: rows[k]["port"] for s, k in keys.items()
            if rows[k].get("code") == row["code"]}
    head = row_key(family, 0, bf16)
    if head in rows:
        rows[head]["gate"] = dict(
            gate(runs, *jax_yardstick(jax_rows, family)), code=row["code"],
            stale=sorted(k for s, k in keys.items() if s not in runs))
    tmp = Path(f"{path}.tmp")
    with open(tmp, "w") as f:
        json.dump(rows, f, indent=1)
    os.replace(tmp, path)
    return rows


def run_row(family, *, bf16=False, seed=0, device=None, work_dir=None):
    """Train and score one row of the family's protocol; returns the
    port's scores with train_seconds, steps, steps_per_second and card."""
    device = resolve_device(device)
    p = PROTOCOLS[family]
    # cuDNN's default may pick a nondeterministic algorithm, and a row then
    # trains differently from run to run
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if not bf16:
        # the f32 rows are the reference numerics: no TF32 anywhere
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    data = family_data(family, p, device)
    model = build_model(family, p, bf16, seed, device)
    with (contextlib.nullcontext(work_dir) if work_dir else
          tempfile.TemporaryDirectory(prefix="parity_")) as d:
        seconds = train(model, family, p, data, seed, device, d)
    port = score(model, family, p, data[1], device)
    steps = p["epochs"] * (p["n_train"] // p["batch_size"])
    port.update(train_seconds=seconds, steps=steps,
                steps_per_second=steps / seconds, card=card_name(device))
    return port


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", required=True, choices=sorted(PROTOCOLS))
    ap.add_argument("--bf16", action="store_true",
                    help="the family CLI's shipped bf16 mode [default: f32]")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device [default: the CUDA card; raises "
                         "without one]")
    ap.add_argument("--out", default=str(PORT_ROWS),
                    help="the port's row file [default: %(default)s]")
    ap.add_argument("--work-dir", default=None,
                    help="checkpoints [default: a temporary directory]")
    ns = ap.parse_args(argv)
    if Path(ns.out).resolve() == JAX_ROWS.resolve():
        ap.error("--out names the JAX package's rows, which stay as they are")
    device = resolve_device(ns.device)
    with open(JAX_ROWS) as f:
        jax_rows = json.load(f)
    port = run_row(ns.family, bf16=ns.bf16, seed=ns.seed, device=device,
                   work_dir=ns.work_dir)
    key = row_key(ns.family, ns.seed, ns.bf16)
    row = make_row(ns.family, PROTOCOLS[ns.family], ns.seed, ns.bf16, port,
                   jax_rows)
    rows = merge_row(ns.out, key, row, jax_rows)
    head = rows.get(row_key(ns.family, 0, ns.bf16), {})
    print(f"[parity] {key}: " + json.dumps(row))
    print(f"[parity] gate {row_key(ns.family, 0, ns.bf16)}: "
          + json.dumps(head.get("gate")))
    return row


if __name__ == "__main__":
    main()
