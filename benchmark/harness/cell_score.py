"""A scoring cell: the IWAE estimate of log p(targets) (core/loglike.py:
iwae_log_marginal), as train/loglike_cli.py runs it: float32 with TF32
off in cuDNN, the proposal over the configured experts, a test split of
host rows read in file order a batch at a time (the last batch of a
pass holds the rest), each copied to the card, its pixels decoded by the
program's decode_batch, and its estimates read back to the host.

score_rows_per_s: the rows scored over the window's time, its last
readback included. score_batch_p95_ms: the 95th percentile of every
batch's time from its host copy to its readback.

The draws come from a generator on the card seeded from --seed; the
generator's state before each batch is kept, so that a sample of the
window's batches (drawn from the seed) is scored again by the plain
reference on the same rows and draws once the program is freed.
"""

import gc
import statistics
import time

import numpy as np
import torch

from harness import cell_train, checks, inputs, port_calls, trace
from harness.yardstick import PEAK_FLOPS, score_flops
from reference import common as ref_common

TRACED_BATCHES = 12


class Rows:
    """The host rows, batches in file order, wrapped."""

    def __init__(self, cfg, traffic, seed, device):
        self.rows = traffic["rows"]
        self.batch = traffic["batch"]
        made = inputs.make_rows(cfg, self.rows, seed, device)
        self.host = {k: v.cpu() for k, v in made.items()}
        self.per_pass = -(-self.rows // self.batch)

    def span(self, j):
        lo = (j % self.per_pass) * self.batch
        return lo, min(lo + self.batch, self.rows)

    def get(self, j):
        lo, hi = self.span(j)
        return {k: v[lo:hi] for k, v in self.host.items()}


def run(ctx):
    cfg, traffic, device = ctx.cfg, ctx.traffic, ctx.device
    from mvae_tpu_torch.core import loglike
    from mvae_tpu_torch.train.loop import decode_batch
    torch.backends.cudnn.allow_tf32 = False     # as the loglike CLI runs
    state = inputs.make_weights(cfg, ctx.seed, device)
    model = cell_train.port_model(cfg, "score", device, state)
    del state
    ctx.log("model built, weights loaded")
    rows = Rows(cfg, traffic, ctx.seed, device)
    ctx.log("rows made")
    k = traffic["samples"]
    proposal = cfg["score"]["proposal"]
    targets = cfg["score"]["targets"]
    gen = inputs.generator(ctx.seed, "noise", device)
    j = 0

    def one(j):
        batch = {n: v.to(device) for n, v in rows.get(j).items()}
        batch = decode_batch(batch, torch.float32)
        return loglike.iwae_log_marginal(model, batch, proposal, targets, k,
                                         generator=gen).cpu()

    # warm-up: the two batch shapes of a pass (full and the rest)
    for j in (0, rows.per_pass - 1):
        one(j)
        ctx.log(f"warm-up batch {j}")
    ctx.setup_done()

    states, outs, times = [], [], []
    j, failed = 0, 0
    t0 = time.perf_counter()
    while True:
        states.append(gen.get_state())
        ta = time.perf_counter()
        out = one(j)
        times.append(time.perf_counter() - ta)
        outs.append(out)
        failed += int((~torch.isfinite(out)).sum())
        j += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    seconds = time.perf_counter() - t0
    n_rows = sum(int(o.shape[0]) for o in outs)
    flops = sum(score_flops(cfg, int(o.shape[0]), k) for o in outs)
    lat = sorted(1e3 * t for t in times)
    metrics = {"score_rows_per_s": n_rows / seconds,
               "score_batch_p95_ms":
                   statistics.quantiles(lat, n=100, method="inclusive")[94]
                   if len(lat) > 1 else lat[0]}
    window = {"seconds": seconds, "units": len(outs), "flops": flops,
              "peak": PEAK_FLOPS[cfg["compute_dtype"]["score"]],
              "enqueue_ms": None}

    traced = None
    if ctx.trace:
        def traced_batches():
            for i in range(TRACED_BATCHES):
                one(j + i)
        with port_calls.recording() as rec:
            traced = trace.capture(traced_batches, device, port_calls.SPAN,
                                   ctx.log)
        traced["calls"] = rec.calls
        traced["units"] = TRACED_BATCHES
        traced["unit"] = "batch"

    ctx.read_memory()
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    picks = check_batches(ctx.seed, len(outs), traffic["check_batches"])
    prog = torch.cat([outs[i] for i in picks])
    ref = reference_scores(cfg, ctx.seed, device, rows, picks, states, k)
    return {"attempted": n_rows, "failed": failed, "metrics": metrics,
            "window": window, "traced": traced,
            "numbers": checks.score_numbers(prog, ref),
            "check": {"prog": prog, "ref": ref, "rows": rows, "picks": picks,
                      "states": states, "samples": k}}


def check_batches(seed, n, count):
    """A sample of the window's batch numbers, drawn from the seed; the
    last batch always among them."""
    rng = np.random.default_rng(inputs.seed_of(seed, "check"))
    picks = rng.choice(max(n - 1, 1), size=min(count, n) - 1, replace=False)
    return sorted(set(int(i) for i in picks) | {n - 1})


def reference_scores(cfg, seed, device, rows, picks, states, k,
                     precision="float32"):
    """The plain reference's estimates of the picked batches from the
    seed's weights, on their rows and draws; precision "tf32" lets the
    products run in TF32 (the control)."""
    import importlib
    fam = importlib.import_module(f"reference.{cfg['reference']}")
    model = fam.Model(cfg)
    params = inputs.make_weights(cfg, seed, device)
    gen = torch.Generator(device=device)
    proposal = torch.tensor(cfg["score"]["proposal"], dtype=torch.float32,
                            device=device)
    ops = ref_common.Ops(None if precision in ("float32", "tf32")
                         else precision)
    out = []
    with ref_common.no_tf32(allow=precision == "tf32"):
        for j in picks:
            x = cell_train.as_float(cfg, {n: v.to(device)
                                          for n, v in rows.get(j).items()})
            gen.set_state(states[j])
            b = next(iter(x.values())).shape[0]
            eps = torch.randn((k, b, cfg["n_latents"]), generator=gen,
                              device=device)
            out.append(ref_common.iwae(model, params, ops, x, proposal,
                                       cfg["score"]["targets"], eps).cpu())
    return torch.cat(out)
