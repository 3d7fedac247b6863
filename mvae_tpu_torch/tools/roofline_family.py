"""Trace and FLOP count of any family's training step (counterpart of
scripts/roofline_family.py, and of scripts/roofline_celeba.py, which it
generalises).

    python -m mvae_tpu_torch.tools.roofline_family --family celeba
        [--bf16] [--k 20] [--top 10] [--trace-dir DIR] [--seed 0]
        [--device cpu]

Builds the family's window as tools/bench_families.py runs it (its spec,
weights and data from --seed), warms it, times its REPS windows without
the profiler (host clock, each ending with the host reading its last
loss), then runs one more under torch.profiler (tools/measure.py:
profile_breakdown): device ms a step, launches a step, the idle share
against the untraced windows' median, device ms by kernel family (each of
the port's eight kernels under its PERF.md name, launched or not), and
the --top N kernels by device time with their launches a step.
--trace-dir writes the traced window's Chrome trace there
(trace_<family>.json).

The FLOPs a step are counted from shapes (measure.flops_per_step); mfu is
their rate over the card's peak for the step's dtype (bf16: 989 TFLOP/s,
float32: 67). The step's compute bound is flops over that peak. A bytes
bound for the whole step (every tensor the step must read and write at
3.35 TB/s) is not counted here: that is left to the benchmark that builds
the cells on these tools.

Prints one JSON line. Runs on the CUDA card unless --device says
otherwise; on the CPU there is no trace and every device metric is null.
"""

import argparse
import json
import os

from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.tools import bench_families, measure


def kernel_rows(prof, top):
    """The port's eight kernels (ms and launches a step, zeros where the
    window launched none) and the top kernels by device time."""
    ours = {k: {"ms": 0.0, "launches": 0.0} for k in measure.PORT_KERNELS}
    for name, ms, launches, fam in prof["kernels"]:
        if fam in ours:
            ours[fam]["ms"] += ms
            ours[fam]["launches"] += launches
    rows = [{"kernel": name[:160], "family": fam, "ms": ms,
             "launches": launches}
            for name, ms, launches, fam in prof["kernels"][:top]]
    return ours, rows


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="vision",
                    choices=bench_families.FAMILY_NAMES)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--top", type=int, default=0)
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card; 'cpu' for a rehearsal "
                         "(its numbers are not the card's)")
    return ap


def main(argv=None):
    """Prints the JSON line; returns it."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    line = measure.device_line(device)
    spec = bench_families.family_spec(args.family, bf16=args.bf16,
                                      seed=args.seed, k=args.k)
    with bench_families.precision(spec):
        model, window = bench_families.build(spec, device, args.seed)
        measure.window_seconds(window)
        wall = [measure.window_seconds(window) * 1e3 / args.k
                for _ in range(bench_families.REPS)]
        wall_ms = measure.spread(wall)["median"]
        prof = None
        if measure.on_card(device):
            trace = None
            if args.trace_dir:
                os.makedirs(args.trace_dir, exist_ok=True)
                trace = os.path.join(args.trace_dir,
                                     f"trace_{args.family}.json")
            prof = measure.profile_breakdown(
                f"roofline {args.family} {spec.compute_dtype} "
                f"B={spec.batch}, a window of {args.k}", window,
                measure.card_text(line), reps=1, per=args.k,
                wall_ms=wall_ms, trace_path=trace)
    flops = bench_families.step_flops(model, spec)
    peak = measure.peak_flops(model)
    out = {"family": args.family,
           "precision": "bf16" if args.bf16 else "f32",
           "batch": spec.batch, "k": args.k,
           "wall_ms_per_step": measure.spread(wall),
           "flops_per_step": flops, "device": line, "seed": args.seed,
           "device_ms_per_step": None, "launches_per_step": None,
           "idle_share": None, "device_ms_by_family": None,
           "port_kernels": None, "top_kernels": None, "mfu": None,
           "compute_bound_ms": None, "bound_by": None, "trace": None}
    if prof is not None:
        ours, rows = kernel_rows(prof, args.top)
        out.update(device_ms_per_step=prof["device_ms"],
                   launches_per_step=prof["launches"],
                   idle_share=prof["idle_share"],
                   device_ms_by_family=prof["families"],
                   port_kernels=ours, top_kernels=rows,
                   mfu=measure.mfu(flops, 1e3 / wall_ms, peak),
                   compute_bound_ms=flops / peak * 1e3,
                   bound_by=f"operations ({measure.PEAK_SOURCE})",
                   trace=trace)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
