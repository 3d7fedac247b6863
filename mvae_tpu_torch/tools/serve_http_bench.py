"""Load on the HTTP serving front (counterpart of
scripts/serve_http_bench.py): C clients x R requests each at /embed.

    python -m mvae_tpu_torch.tools.serve_http_bench [CHECKPOINT] \
        [--clients 16] [--requests 8] [--rows 1] \
        [--windows 0 2] [--device cpu]

Starts the real ThreadingHTTPServer of mvae_tpu_torch/serve_http.py on
127.0.0.1 (an ephemeral port), warms the embed buckets a coalesced batch
can reach, and fires C concurrent clients, each R requests in a row of
`--rows` image rows in the binary wire format. The clients are threads of
one spawned process, so they share no interpreter lock with the server.
Each window runs twice, the windows in turns (0, 2, 2, 0 by default): a
0 ms window dispatches each drain at once, the 2 ms window coalesces.
Prints one JSON line a run: requests/s, p50 and p95 latency per request
(host clock, ms), the device calls the batcher made and the mean rows a
call. Without a checkpoint it serves MnistMVAE(64) with random weights
from seed 0. Runs on the CUDA card unless --device says otherwise.
"""

import argparse
import json
import multiprocessing
import statistics
import threading
import time
import urllib.request

import numpy as np
import torch

from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models import MnistMVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.serve_http import (
    ServeApp, encode_array, make_server, numpy_dtype, warmup_buckets)


def request_rows(sampler, rows, seed=0):
    """`rows` rows of the image modality, uniform in [0, 1) in its
    input_spec dtype."""
    shape, dtype = sampler.model.input_spec()["image"]
    return np.random.default_rng(seed).random(
        (rows,) + tuple(shape)).astype(numpy_dtype(dtype))


def warm_embed(sampler, max_rows):
    """One embed at each bucket a drained batch of up to max_rows rows
    reaches, so that the timed runs meet no first call."""
    for m in warmup_buckets(max_rows):
        sampler.embed({"image": request_rows(sampler, m)})
    if sampler.device.type == "cuda":
        torch.cuda.synchronize(sampler.device)


def post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/embed", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        out = json.load(r)
    if set(out) != {"mu", "logvar"}:
        raise RuntimeError(f"/embed answered {sorted(out)}")


def run_clients(port, body, clients, requests):
    """C client threads, R POSTs of `body` each, all started together:
    returns (latencies in ms, wall s, the first error or None). It runs
    in a process of its own (bench), so the clients share no interpreter
    lock with the server's threads."""
    lat, lock, errors = [], threading.Lock(), []

    def client():
        try:
            for _ in range(requests):
                t0 = time.perf_counter()
                post(port, body)
                dt = (time.perf_counter() - t0) * 1e3
                with lock:
                    lat.append(dt)
        except Exception as e:              # reported after the join
            errors.append(repr(e))

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return lat, time.perf_counter() - t0, (errors or [None])[0]


def bench_one(sampler, window_ms, clients, requests, rows, pool):
    """One burst against a fresh ServeApp behind HTTP, the clients in the
    process of `pool`: returns its numbers (unrounded)."""
    app = ServeApp(sampler, window_ms=window_ms)
    srv = make_server(app, "127.0.0.1", 0)
    port = srv.server_address[1]
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    body = json.dumps({"inputs": {"image": encode_array(
        request_rows(sampler, rows), binary=True)}, "binary": True}).encode()
    try:
        post(port, body)                    # the connection path, warm
        calls0 = app._batcher.device_calls
        lat, wall, error = pool.apply(run_clients,
                                      (port, body, clients, requests))
        calls = app._batcher.device_calls - calls0
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()
        server.join(timeout=10)
    if error:
        raise RuntimeError(f"a client failed: {error}")
    n = clients * requests
    if len(lat) != n:
        raise RuntimeError(f"{len(lat)} of {n} requests answered")
    q = statistics.quantiles(lat, n=20)
    return {"window_ms": window_ms, "clients": clients,
            "requests": n, "rows": rows, "wall_s": wall,
            "req_per_s": n / wall, "p50_ms": statistics.median(lat),
            "p95_ms": q[18], "device_calls": calls,
            "mean_rows_per_call": n * rows / max(calls, 1)}


def bench(sampler, windows, clients, requests, rows):
    """The windows in turns (each twice, the second pass reversed), the
    clients in one spawned process for all the runs."""
    warm_embed(sampler, clients * rows)
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return [bench_one(sampler, w, clients, requests, rows, pool)
                for w in list(windows) + list(windows)[::-1]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--windows", type=float, nargs="+", default=[0.0, 2.0])
    ap.add_argument("--device", default=None,
                    help="torch device [default: the CUDA card; raises "
                         "without one]")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device)
    if ns.checkpoint:
        sampler = Sampler.from_checkpoint(ns.checkpoint, device=device)
    else:
        sampler = Sampler(MnistMVAE(64, device=device), device=device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"{type(sampler.model).__name__} on {where}: clients="
          f"{ns.clients} requests/client={ns.requests} rows/request="
          f"{ns.rows}", flush=True)
    out = bench(sampler, ns.windows, ns.clients, ns.requests, ns.rows)
    for r in out:
        print(json.dumps(r), flush=True)
    return out


if __name__ == "__main__":
    main()
