"""The readings the limits of a cell's comparison are set from
(harness/checks.py, limits/<workload>.json), on the card at the cell's
own size:

    python3 benchmark/calibrate.py --workload <name> --seeds a,b,... \
        [--control-seeds c,...] [--fault-seeds f,...] [--seconds 2]

For each seed, the program's numbers against the plain reference (a
training cell: the check that set-up drives, cell_train.Program, no
window; a scoring cell: a short window of --seconds at the cell's own
load, compared as a run compares it). For each control seed, the control's: the reference itself computed
in the precision below the configuration's (bf16 training: fp8 e4m3
operands; float32 scoring: TF32), against the float32 reference. For
each fault seed (training cells), the program fed half of each step's
rows. One JSON line each on standard output. Not run by the benchmark's
own runs.
"""

import json
import sys
import time

import run as bench

LOWER = {"bfloat16": "fp8_e4m3", "float32": "tf32"}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    bench.pin_environment()
    import torch
    from harness import cell_score, cell_train, checks

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    cell = {w["name"]: w for w in bench.load_spec()["workloads"]}[
        args.workload]
    cfg = bench.load_json(bench.HERE / "configs" / f"{cell['config']}.json")
    traffic = bench.load_json(bench.HERE / "traffic" /
                              f"{cell['traffic']}.json")
    device = torch.device("cuda", 0)
    kind = traffic["loop"]
    lower = LOWER[cfg["compute_dtype"][kind]]
    every = sorted(set(seeds(args.seeds) + seeds(args.control_seeds)
                       + seeds(args.fault_seeds)))

    def emit(**kw):
        print(json.dumps(kw), flush=True)

    for seed in every:
        t0 = time.perf_counter()
        if kind == "train":
            prog = cell_train.Program(cfg, traffic, seed, device)
            prog.free()
            ref = prog.reference(cfg, seed)
            if seed in seeds(args.seeds):
                emit(seed=seed, who="program",
                     numbers=checks.train_numbers(prog.prog, ref))
            if seed in seeds(args.control_seeds):
                ctl = prog.reference(cfg, seed, lower)
                emit(seed=seed, who="control " + lower,
                     numbers=checks.train_numbers(ctl, ref))
            if seed in seeds(args.fault_seeds):
                half = cell_train.Program(cfg, traffic, seed, device,
                                          half=True)
                half.free()
                emit(seed=seed, who="fault half batch",
                     numbers=checks.train_numbers(half.prog, ref))
        else:
            ctx = bench.Context(argparse.Namespace(
                seed=seed, seconds=args.seconds, trace=0), cfg, traffic,
                device)
            out = cell_score.run(ctx)
            c = out["check"]
            if seed in seeds(args.seeds):
                emit(seed=seed, who="program", numbers=out["numbers"])
            if seed in seeds(args.control_seeds):
                ctl = cell_score.reference_scores(
                    cfg, seed, device, c["rows"], c["picks"], c["states"],
                    c["samples"], precision=lower)
                emit(seed=seed, who="control " + lower,
                     numbers=checks.score_numbers(ctl, c["ref"]))
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
