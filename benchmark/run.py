"""The benchmark of the PyTorch/CUDA port (mvae_tpu_torch) on one NVIDIA
card: one cell of BENCHMARK.json a run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell names its configuration
(configs/<config>.json), its traffic (traffic/<traffic>.json, whose
"loop" picks the general loop that reads it: harness/cell_<loop>.py), and the
limits of its comparison (limits/<workload>.json); each per-layer metric
is read by metrics/<metric>.py. All of them are found by name, so a cell,
a configuration or a metric is added by adding files and entries.

The run makes its weights and data from --seed on the card, warms the
cell's shapes up (set-up, setup_s), measures for --seconds, then checks
what the timed path produced against the plain reference
(harness/checks.py). With --trace 0 it reports the cell's end-to-end
metrics; with --trace 1 it also captures a few windows under
torch.profiler and reports the per-layer metrics. The last line of
standard output is one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error and the last key of that
object. It exits with another code than 0, printing no result, without a
CUDA card, or if the JAX package or JAX is loaded once the window has
closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "benchmark_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "mvae_tpu")


def pin_environment():
    """Fixed cache directories inside the checkout, and no JAX pulled in by
    a library."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_spec():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def metric_reader(name):
    """metrics/<name>.py's read(trace, window) function."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg):
    print(f"[bench] {time.perf_counter() - T_START:8.3f} s  {msg}",
          file=sys.stderr, flush=True)


class Context:
    def __init__(self, args, cfg, traffic, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.seed, self.seconds, self.trace = args.seed, args.seconds, \
            bool(args.trace)
        self.setup_s = None
        self.memory_peak = None
        self.log = log

    def setup_done(self):
        self.setup_s = time.perf_counter() - T_START

    def read_memory(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)
        else:
            self.memory_peak = 0


def device_info(device, count):
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count}


def per_layer(spec, workload, traced, window):
    """The cell's per-layer metrics that its readers find something to
    read for."""
    out = {}
    for m in spec["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        value = metric_reader(m["name"])(traced, window)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, *, device=None):
    """Run one cell; returns the exit code. device: a torch.device to run
    on without the look for a card (the tests' CPU runs)."""
    ap = argparse.ArgumentParser(description="one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_environment()
    import torch
    log("torch imported")

    spec = load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = cells[args.workload]
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            found = (torch.cuda.device_count()
                     if torch.cuda.is_available() else 0)
            log(f"needs {cell['chips']} CUDA card(s); found {found}")
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        log(f"CUDA context on {torch.cuda.get_device_name(device)}")
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    from harness import checks, inputs
    try:
        inputs.check_terms(cfg)
    except ValueError as e:
        log(f"configuration {cell['config']!r} refused: {e}")
        return 2
    limits = checks.load_limits(HERE, args.workload)
    loop = importlib.import_module(f"harness.cell_{traffic['loop']}")
    ctx = Context(args, cfg, traffic, device)
    result = loop.run(ctx)
    log(f"set-up {ctx.setup_s} s, the check done")

    found = forbidden_modules()
    if found:
        log(f"loaded after the window: {', '.join(found)}; no result")
        return 4
    if args.trace:
        metrics = per_layer(spec, args.workload, result["traced"],
                            result["window"])
    else:
        metrics = {k: {"value": v, "unit": unit_of(spec, k)}
                   for k, v in result["metrics"].items()}
        metrics["setup_s"] = {"value": ctx.setup_s, "unit": "s"}
    correct, rows = checks.verdict(result["numbers"], limits)
    if result["failed"]:
        correct = False
    dev = device_info(device, cell["chips"])
    dev["memory_peak_bytes"] = ctx.memory_peak
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        tr = result["traced"]
        from harness import trace as tr_mod
        busy = tr_mod.busy_intervals(tr["records"], tr["window"])
        dev["busy_s"] = sum(b - a for a, b in busy) / 1e9
        dev["window_s"] = (tr["window"][1] - tr["window"][0]) / 1e9
        line["breakdown"] = {
            "device_ops": tr_mod.device_ops(tr["records"]),
            "idle_gaps": tr_mod.idle_gaps(busy, tr["window"], tr["host"])}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in rows}
    for name, v in result["numbers"].items():
        if name not in limits:
            print(f"reading {name} {v!r} (not compared)", file=sys.stderr)
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def unit_of(spec, name):
    return next(m["unit"] for m in spec["end_to_end"] if m["name"] == name)


if __name__ == "__main__":
    sys.exit(main())
