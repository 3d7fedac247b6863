"""The harness is driven by data: in a copy of the checkout, a throwaway
configuration, traffic mix and per-layer metric, each a new file with its
BENCHMARK.json entry, are found and run by name, no existing file edited.
So is a vision-shaped configuration, whose terms reconstruct modalities
apart from their experts (terms.recon_masks) and whose six encoders each
draw a keep-mask row of their own; a run that gives the port the
posterior masks as its reconstruction masks, or every encoder the first
keep row, comes out not correct."""

import hashlib
import json

import pytest

from conftest import BENCH, add_cell, run_cell, vision_config


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_traffic_and_metric_run_without_edits(checkout):
    bench = checkout / "benchmark"
    before = digests(bench)
    cfg = json.loads((bench / "configs" / "celeba.json").read_text())
    latents = 16
    cfg["n_latents"] = latents
    st = cfg["stacks"]
    st["image_encoder.classifier"][-1] = ["linear", 512, 2 * latents]
    st["image_decoder.upsample"][0] = ["linear", latents, 6400]
    st["attrs_encoder.net"][-1] = ["linear", 512, 2 * latents]
    st["attrs_decoder.net"][0] = ["linear", latents, 512]
    (bench / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "throwaway_mix.json").write_text(json.dumps(
        {"loop": "train", "batch": 3, "steps_per_window": 1, "rows": 24}))
    (bench / "metrics" / "throwaway_metric.py").write_text(
        "def read(traced, window):\n"
        "    return float(window['units'])\n")
    (bench / "limits" / "throwaway.cell.json").write_text(json.dumps(
        {"limits": {"grad_gap": 1.0, "change_gap": 1.0}}))
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway", "source": "test",
                            "file": "benchmark/configs/throwaway.json",
                            "reduced": ["n_latents"], "why": "test"})
    spec["workloads"].append({"name": "throwaway.cell", "config": "throwaway",
                              "traffic": "throwaway_mix", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "throwaway_metric", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "train loop",
                              "moves": "train_samples_per_s",
                              "workloads": ["throwaway.cell"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec))

    rc, line, err = run_cell(checkout, "throwaway.cell")
    assert rc == 0, err[-3000:]
    assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert line["correct"] is True
    rc, line, err = run_cell(checkout, "throwaway.cell", trace=1)
    assert rc == 0, err[-3000:]
    assert line["metrics"]["throwaway_metric"]["value"] >= 1
    assert "launches_per_step.train" not in line["metrics"]   # not listed
    after = digests(bench)
    assert all(after[p] == d for p, d in before.items())


# the step's loss weighs the posterior masks; its decode plan, from the
# recon masks, stays the one batch that VisionMVAE runs
POSTERIOR_RECON = (
    "from mvae_tpu_torch.train import loop\n"
    "_elbo = loop.multi_term_elbo\n"
    "def posterior(*a, **kw):\n"
    "    kw['recon_masks'] = None\n"
    "    return _elbo(*a, **kw)\n"
    "loop.multi_term_elbo = posterior")
KEEP_ROW_0 = (
    "from mvae_tpu_torch.train import loop\n"
    "_draw = loop.draw_noise\n"
    "def row0(*a, **kw):\n"
    "    eps, keep, *rest = _draw(*a, **kw)\n"
    "    return (eps, keep[:1].expand_as(keep), *rest)\n"
    "loop.draw_noise = row0")
VISION_LIMITS = json.loads(
    (BENCH / "limits" / "celeba19.train.b2048.json").read_text())["limits"]


@pytest.mark.parametrize("fault", [None, POSTERIOR_RECON, KEEP_ROW_0],
                         ids=["sound", "posterior_recon", "keep_row_0"])
def test_vision_shaped_config_runs_by_name(checkout, fault):
    """Published stacks, n_latents cut to 8, a batch of 3, celeba19's
    limits. It trains in float32, so that the comparison reads the
    plumbing and not bf16's rounding at 3 rows (the sound run reads
    grad_gap 2.0e-06 to 2.8e-06 in float32 on three seeds, 0.011 to 0.031
    in bf16; each fault 0.15 or more)."""
    bench = checkout / "benchmark"
    before = digests(bench)
    cfg = vision_config(8)
    cfg["compute_dtype"]["train"] = "float32"
    add_cell(checkout, "vision_shaped", cfg,
             {"loop": "train", "batch": 3, "steps_per_window": 1,
              "rows": 12}, VISION_LIMITS)
    rc, line, err = run_cell(checkout, "vision_shaped", patch=fault or "")
    assert rc == 0, err[-3000:]
    assert line["correct"] is (fault is None), line["checks"]
    after = digests(bench)
    assert all(after[p] == d for p, d in before.items())
