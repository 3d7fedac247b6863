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
