"""The harness is driven by data: in a copy of the checkout, a throwaway
configuration, traffic mix and per-layer metric, each a new file with its
BENCHMARK.json entry, are found and run by name, no existing file edited."""

import hashlib
import json

from conftest import BENCH, run_cell


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
