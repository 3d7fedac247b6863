"""The CelebA training window by kernel category, with the step's FLOP and
byte bound on the card (counterpart of scripts/roofline_celeba.py).

    python -m mvae_tpu_torch.tools.roofline_celeba [--capture]
        [--trace-dir DIR] [--k 20] [--seed 0] [--device cpu]

1. --capture runs the port's CelebA train CLI
   (experiments/celeba/train.py:main, in this process) with the JAX
   script's arguments (CAPTURE_ARGV: one epoch of the synthetic set,
   B = 100, annealing 1, L = 100, windows of 20 steps; the CLI's bf16 and
   default, unfused route) once, then again with --profile-dir DIR: the
   driver traces the epoch's window (its second, or its first where an
   epoch holds one) and writes DIR/trace.json. Without --capture the tool
   reads a trace.json already there, taken with those arguments.
2. The trace's device events (torch.profiler's Chrome trace; one that
   lost more than measure.LOST_MAX kernel records is refused, and the
   records lost are reported), each linked to the aten op that launched
   it: the window's device ms, device ms and launches a step, and each
   kernel family's us a step, share and launches a step
   (tools/measure.py:family_of, as tools/roofline_family.py's); the
   steps are the trace's Adam steps (else --k). The wall ms a step is
   the same step's without the profiler, as tools/bench.py times it
   (WINDOWS windows of --k steps, each ended by the host reading its
   last loss; the traced window's wall, which the profiler stretches, is
   reported beside it), and the idle share is 1 - the device ms over its
   median.
3. The cost roofline of the same step, counted from shapes on the model
   the CLI trains (CelebaMVAE(L), weights from --seed): the FLOPs a step
   (measure.count_step: needed and dead), bytes_ops and bytes_floor
   (measure.count_step_bytes) and each one's time at the card's memory
   rate, 3.35 TB/s; the step's bound, the larger of the FLOPs at the
   peak and bytes_floor at the memory rate, what sets it, and its share
   of the device ms and of the wall ms a step.

bytes_ops is an upper bound on the step's traffic: every op reads its
inputs and writes its outputs once, the counterpart of XLA's "bytes
accessed". bytes_floor is a floor: what any implementation of the step
must move. Prints one JSON line. Runs on the CUDA card unless --device
says otherwise; on the CPU the trace has no kernels and every device
metric is null.
"""

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.experiments.celeba import train as celeba_cli
from mvae_tpu_torch.models.celeba import N_ATTRS, CelebaMVAE
from mvae_tpu_torch.tools import measure
from mvae_tpu_torch.train.loop import make_multi_train_step

# scripts/roofline_celeba.py:33-43
CAPTURE_ARGV = ["--epochs", "1", "--batch-size", "100",
                "--annealing-epochs", "1", "--n-latents", "100",
                "--log-interval", "20"]
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         os.pardir, os.pardir, "build", "roofline_celeba")
MASKS = celeba_cli.TERM_MASKS
N_ROWS = 2000           # the untraced windows' resident rows (the CLI's set)
WINDOWS = 3             # untraced windows after one warm-up
NOTES = {
    "bytes_ops": "upper bound: every op of the step reads each tensor "
                 "input once and writes each output once (XLA's 'bytes "
                 "accessed'); a port kernel is one op",
    "bytes_floor": "floor: the batch's uint8 rows, the parameters (read "
                   "twice, written once), gradients (written, read), "
                   "Adam's moments (read, written), the BN running "
                   "statistics (read, written) and every tensor autograd "
                   "saves (written, read once)"}


def capture(trace_dir, work_dir, device_arg=None):
    """The CLI's run with --profile-dir trace_dir (the module docstring),
    after one run without it: at 20 steps an epoch the traced window is
    the epoch's first, and this process has then built the kernels and
    set cuDNN up already. The traced run is made again where its trace
    lost more than measure.LOST_MAX kernel records (measure.kept_capture).
    The checkpoints and data directory under work_dir."""
    argv = CAPTURE_ARGV + [
        "--out-dir", os.path.join(work_dir, "models"),
        "--data-dir", os.path.join(work_dir, "no_data")]
    if device_arg is not None:
        argv += ["--device", device_arg]
    celeba_cli.main(argv)

    def traced():
        celeba_cli.main(argv + ["--profile-dir", trace_dir])
        records, _, launched, _, _ = measure.trace_records(
            os.path.join(trace_dir, "trace.json"))
        return None, records, launched

    measure.kept_capture("roofline_celeba --capture", traced)


def analyze(trace, k):
    """The window's numbers from a Chrome trace (a path or its object); k:
    the steps of the window where the trace holds no Adam step."""
    records, launches, launched, wall_us, steps = measure.trace_records(
        trace)
    steps = steps or k
    groups, kernels, launchers = measure.breakdown(records, steps)
    dev_ms = sum(groups.values())
    linked = sum(1 for _, op, _ in records if op is not None)
    return {"records_lost": measure.records_lost(records, launched),
            "steps": steps, "window_device_ms": dev_ms * steps,
            "device_ms_per_step": dev_ms,
            "wall_ms_per_step": wall_us / 1e3 / steps,
            "launches_per_step": launches / steps,
            "kernels_linked_to_an_op": linked / max(len(records), 1),
            "categories": [
                {"family": fam, "us_per_step": ms * 1e3,
                 "share": ms / dev_ms,
                 "launches_per_step": sum(n for _, _, n, f in kernels
                                          if f == fam)}
                for fam, ms in sorted(groups.items(), key=lambda kv: -kv[1])],
            "launchers": launchers}


def cli_step(args, device, seed, rows):
    """The CLI's model (weights from seed), its term weights and `rows`
    random resident rows on the device."""
    model = CelebaMVAE(args.n_latents, torch.bfloat16 if args.bf16 else None,
                       conv_moments=args.conv_moments, device=device,
                       generator=torch.Generator().manual_seed(seed))
    lambdas = [[args.lambda_image, args.lambda_attrs]] * len(MASKS)
    rng = np.random.default_rng(seed)
    data = {"image": torch.from_numpy((rng.random((rows, 64, 64, 3)) * 255)
                                      .astype(np.uint8)).to(device),
            "attrs": torch.from_numpy((rng.random((rows, N_ATTRS)) < 0.3)
                                      .astype(np.float32)).to(device)}
    return model, lambdas, data


def untraced_wall(args, device, seed, k):
    """ms a step of the CLI's step without the profiler, as tools/bench.py
    times it: train/loop.py:make_multi_train_step over N_ROWS resident
    rows, one warm-up window of k steps, then WINDOWS windows, each ended
    by the host reading its last loss; their spread."""
    model, lambdas, data = cli_step(args, device, seed, N_ROWS)
    multi = make_multi_train_step(
        model, MASKS, lambdas, lr=args.lr, device=device,
        generator=torch.Generator(device=device).manual_seed(seed))
    rng = np.random.default_rng(seed)
    betas = torch.full((k,), 0.5, device=device)
    ms = []
    for _ in range(1 + WINDOWS):
        idxs = torch.from_numpy(rng.integers(0, N_ROWS, (k, args.batch_size))
                                ).to(device)
        ms.append(measure.window_seconds(
            lambda: multi(data, idxs, betas)) * 1e3 / k)
    return measure.spread(ms[1:])


def cost(args, device, seed):
    """The cost roofline's counts of the CLI's step (the module
    docstring) from the CLI's arguments."""
    b = args.batch_size
    model, lambdas, data = cli_step(args, device, seed, b)
    flops = measure.count_step(model, MASKS, lambdas, b)
    nbytes = measure.count_step_bytes(model, MASKS, lambdas, data, b,
                                      seed=seed)
    peak = measure.peak_flops(model)
    rate = measure.HBM_BYTES_PER_S
    return {"flops_per_step": flops.needed, "dead_flops_per_step": flops.dead,
            "bytes_ops": nbytes.ops, "bytes_ops_ms": nbytes.ops / rate * 1e3,
            "ops_counted": nbytes.n_ops, "bytes_floor": nbytes.floor,
            "bytes_floor_ms": nbytes.floor / rate * 1e3,
            "bytes_floor_parts": nbytes.parts,
            "saved_weight_copies_bytes": nbytes.saved_weights,
            **measure.step_bound(flops.needed, nbytes.floor, peak),
            "peak": measure.PEAK_SOURCE, "memory_rate": measure.HBM_SOURCE,
            "notes": NOTES}


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--capture", action="store_true",
                    help="run the CelebA train CLI with --profile-dir "
                         "first (one epoch)")
    ap.add_argument("--trace-dir", default=TRACE_DIR)
    ap.add_argument("--k", type=int, default=20,
                    help="steps of the traced window, where the trace "
                         "holds no Adam step")
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
    trace_dir = os.path.abspath(args.trace_dir)
    if args.capture:
        with tempfile.TemporaryDirectory(prefix="roofline_celeba_") as work:
            capture(trace_dir, work, args.device)
    trace = os.path.join(trace_dir, "trace.json")
    if not os.path.exists(trace):
        raise SystemExit(f"no trace.json under {trace_dir}; run --capture")
    cli = celeba_cli.parser().parse_args(CAPTURE_ARGV)
    window = analyze(trace, args.k)
    if window["records_lost"] > measure.LOST_MAX:
        raise SystemExit(f"{trace} lost {window['records_lost']} kernel "
                         f"records; run --capture")
    out = {"config": (f"CelebaMVAE({cli.n_latents}) "
                      f"{'bf16' if cli.bf16 else 'f32'}, B={cli.batch_size}, "
                      f"T={len(MASKS)}, the CLI's "
                      f"{'fused' if cli.conv_moments else 'default'} route"),
           "trace": trace, "steps": window["steps"], "seed": args.seed,
           "device": line, **cost(cli, device, args.seed)}
    device_keys = ("window_device_ms", "device_ms_per_step",
                   "launches_per_step", "records_lost",
                   "kernels_linked_to_an_op",
                   "categories")
    on_card = measure.on_card(device)
    out.update({key: window[key] if on_card else None for key in device_keys})
    out.update(traced_wall_ms_per_step=window["wall_ms_per_step"],
               wall_ms_per_step=None, idle_share=None,
               bound_share_of_device=None, bound_share_of_wall=None)
    if on_card:
        wall = untraced_wall(cli, device, args.seed, args.k)
        dev_ms = window["device_ms_per_step"]
        out.update(wall_ms_per_step=wall, idle_share=1 - dev_ms
                   / wall["median"],
                   bound_share_of_device=out["bound_ms"] / dev_ms,
                   bound_share_of_wall=out["bound_ms"] / wall["median"])
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
