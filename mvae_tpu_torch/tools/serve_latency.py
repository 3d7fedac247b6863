"""Serving latency of every Sampler endpoint (counterpart of
scripts/serve_latency.py).

    python -m mvae_tpu_torch.tools.serve_latency [CHECKPOINT.pth.tar]
        [--model mnist] [--seed 0] [--device cpu]

Serves a `.pth.tar` checkpoint of the --model family; without one, what
the JAX script serves (its _quick_sampler): MnistMVAE(64) after 20
Adam(1e-3) steps of the three-term ELBO (lambdas 1, 10) at beta 0.1 on
512 synthetic digits from --seed; for another family the same 20 steps
on the model, terms and first rows of a batch of tools/bench_families.py's
spec. The model serves in float32, as serve_http.py serves a checkpoint.

After Sampler.warmup at buckets 1 and 64, each endpoint runs CALLS times
at n = 1 and n = 64: the prior sample, and for each modality the sample
conditioned on one row of it, embed and reconstruct. Each call is timed
by the host clock around the call and a synchronize. One JSON line an
endpoint and bucket: p50 (the median) and p95 (the JAX script's
ts[int(0.95 * n)] of the sorted times: the largest of 20) in ms, the
call count. Runs on the CUDA card unless --device says otherwise.
"""

import argparse
import json
import statistics
import time

import numpy as np
import torch

from mvae_tpu_torch.data.mnist import synthetic_mnist
from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models import MnistMVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.tools import bench_families, measure
from mvae_tpu_torch.train.loop import make_train_step

BUCKETS = (1, 64)
CALLS = 20
QUICK_STEPS = 20


def quick_sampler(family, device, seed=0):
    """The Sampler served without a checkpoint (the module docstring)."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    if family == "mnist":
        model = MnistMVAE(64, device=device,
                          generator=torch.Generator().manual_seed(seed))
        step = make_train_step(model, bench_families.MASKS,
                               bench_families.LAMBDAS, lr=1e-3,
                               generator=gen, device=device)
        imgs, labels = synthetic_mnist(512, seed=seed)
        batch = {"image": torch.from_numpy(imgs.reshape(512, 784)).to(device),
                 "text": torch.from_numpy(labels).to(device)}
    else:
        spec = bench_families.family_spec(family, seed=seed)
        model = spec.model_cls(spec.width, spec.compute_dtype, device=device,
                               generator=torch.Generator().manual_seed(seed),
                               **spec.model_kw)
        step = make_train_step(model, spec.masks, spec.lambdas, lr=1e-3,
                               generator=gen, device=device,
                               recon_masks=spec.recon_masks)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[:spec.batch]))
                 .to(device) for k, v in spec.data.items()}
    for _ in range(QUICK_STEPS):
        step(batch, 0.1)
    return Sampler(model.eval(), device=device)


def request(spec, name, n, rng):
    """n rows of modality `name`: uniform in [0, 1) for a float input,
    integers in [0, 10) otherwise (a class or a token)."""
    shape, dtype = spec[name]
    if dtype.is_floating_point:
        x = rng.random((n,) + tuple(shape)).astype(np.float32)
    else:
        x = rng.integers(0, 10, (n,) + tuple(shape))
    return torch.from_numpy(x).to(dtype)


def endpoints(sampler, rng):
    """(endpoint, condition, bucket, fn) for every endpoint and bucket."""
    spec = sampler.model.input_spec()
    dev = sampler.device
    out = []
    for n in BUCKETS:
        out.append(("sample", None, n, lambda s, n=n: sampler.sample(
            n=n, seed=s)))
        for m in sorted(spec):
            one = request(spec, m, 1, rng).to(dev)
            rows = request(spec, m, n, rng).to(dev)
            out += [
                ("sample", m, n, lambda s, n=n, one=one, m=m:
                 sampler.sample(n=n, seed=s, condition={m: one})),
                ("embed", m, n, lambda s, rows=rows, m=m:
                 sampler.embed({m: rows})),
                ("reconstruct", m, n, lambda s, rows=rows, m=m:
                 sampler.reconstruct({m: rows}))]
    return out


def latencies(fn, device):
    """Host ms of each of CALLS calls, each ended by a synchronize,
    sorted."""
    ts = []
    for i in range(CALLS):
        t0 = time.perf_counter()
        fn(i + 1)
        measure.sync(device)
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--model", default="mnist",
                    choices=bench_families.FAMILY_NAMES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card; 'cpu' for a rehearsal "
                         "(its numbers are not the card's)")
    return ap


def main(argv=None):
    """Prints one JSON line an endpoint and bucket; returns them."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    line = measure.device_line(device)
    if args.checkpoint:
        sampler = Sampler.from_checkpoint(args.checkpoint, device=device,
                                          family=args.model)
    else:
        sampler = quick_sampler(args.model, device, args.seed)
    sampler.warmup(BUCKETS)
    measure.sync(device)
    rng = np.random.default_rng(args.seed)
    rows = []
    for endpoint, cond, n, fn in endpoints(sampler, rng):
        ts = latencies(fn, device)
        row = {"endpoint": endpoint, "condition": cond, "bucket": n,
               "p50_ms": statistics.median(ts), "p95_ms": ts[int(len(ts) * 0.95)], "calls": len(ts),
               "model": args.model, "checkpoint": args.checkpoint,
               "device": line, "seed": args.seed}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
