"""Fixtures of the benchmark's tests: the benchmark's folders on sys.path,
and scratch checkouts in which a cell runs on the CPU at a tiny size.

    python -m pytest benchmark/tests -q        # CPU; the card's tests skip
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"train": {"batch": 4, "steps_per_window": 2, "rows": 64},
        "score": {"batch": 4, "samples": 3, "rows": 10, "check_batches": 2}}


def make_checkout(dest: Path, tiny=True) -> Path:
    """A checkout holding BENCHMARK.json, a copy of benchmark/ (its traffic
    cut to TINY where tiny) and a link to the program."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    os.symlink(ROOT / "mvae_tpu_torch", dest / "mvae_tpu_torch")
    if tiny:
        for path in (dest / "benchmark" / "traffic").glob("*.json"):
            t = json.loads(path.read_text())
            t.update(TINY[t["loop"]])
            path.write_text(json.dumps(t))
    return dest


def run_cell(root: Path, workload: str, *, trace=0, seed=3000000019,
             seconds=0.5, patch="", timeout=900):
    """One run of a cell in the checkout `root`, on the CPU (the look for
    a card skipped), in a fresh process; `patch`: Python run before it,
    to break the timed path underneath. Returns (exit code, the result
    line or None, standard error)."""
    code = "\n".join([
        "import sys, torch",
        "sys.path.insert(0, 'benchmark')",
        patch,
        "import run",
        f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
        f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], "
        "device=torch.device('cpu')))"])
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=timeout)
    line = None
    if p.returncode == 0:
        line = json.loads(p.stdout.strip().splitlines()[-1])
    return p.returncode, line, p.stderr


def vision_config(latents=8):
    """A vision-shaped configuration: VisionMVAE's six image experts at
    their published stacks (CelebA's image encoder and decoder, 3, 1, 1,
    1, 3 and 3 channels), a dropout in each encoder, the joint term and
    one term a modality, each reconstructing all six modalities at
    weight 1/6 (recon_masks all ones); n_latents cut to `latents`."""
    base = json.loads((BENCH / "configs" / "celeba.json").read_text())
    channels = {"image": 3, "gray": 1, "edge": 1, "mask": 1,
                "obscured": 3, "watermark": 3}
    kinds = {"edge": {"kind": "bits", "p": 0.1},
             "mask": {"kind": "bits", "p": 0.2}}
    st = base["stacks"]
    stacks, experts, inputs = {}, [], {}
    for m, c in channels.items():
        enc = json.loads(json.dumps(st["image_encoder.features"]))
        enc[1] = ["conv", c, 32, 4, 2, 1]
        head = json.loads(json.dumps(st["image_encoder.classifier"]))
        head[-1] = ["linear", 512, 2 * latents]
        up = json.loads(json.dumps(st["image_decoder.upsample"]))
        up[0] = ["linear", latents, 6400]
        dec = json.loads(json.dumps(st["image_decoder.hallucinate"]))
        dec[-2] = ["convT", 32, c, 4, 2, 1]
        names = [f"{m}_encoder.features", f"{m}_encoder.classifier",
                 f"{m}_decoder.upsample", f"{m}_decoder.hallucinate"]
        stacks.update(zip(names, (enc, head, up, dec)))
        experts.append({"name": m, "encoder": names[:2],
                        "decoder": names[2:]})
        inputs[m] = {"shape": [64, 64, c],
                     **kinds.get(m, {"kind": "pixels"})}
    n = len(channels)
    masks = [[1] * n] + [[int(i == j) for j in range(n)] for i in range(n)]
    return {
        "about": "test: vision-shaped", "reference": "celeba",
        "port": {"model": "mvae_tpu_torch.models.vision:VisionMVAE",
                 "kwargs": {}},
        "compute_dtype": {"train": "bfloat16", "score": "float32"},
        "n_latents": latents, "inputs": inputs, "experts": experts,
        "stacks": stacks,
        "terms": {"masks": masks, "recon_masks": [[1] * n] * (n + 1),
                  "lambdas": [[1 / n] * n] * (n + 1), "sampled": 0},
        "train": {"lr": 0.0001, "beta": 1.0},
        "score": {"proposal": [1] * n, "targets": ["image"]}}


def add_cell(root: Path, name, cfg, traffic, limits):
    """A configuration, a traffic mix, the cell's limits and the
    BENCHMARK.json entries of a cell `name`, all named `name`, added to
    the checkout `root` as new files."""
    bench = root / "benchmark"
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    (bench / "limits" / f"{name}.json").write_text(json.dumps(
        {"limits": limits}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": name, "source": "test",
                            "file": f"benchmark/configs/{name}.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": name, "config": name,
                              "traffic": name, "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "celeba.train.b4096" in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def checkout(tmp_path):
    return make_checkout(tmp_path / "checkout")


@pytest.fixture
def card():
    """The CUDA device, decided when the test runs; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
