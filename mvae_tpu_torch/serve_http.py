"""HTTP serving front with dynamic micro-batching (counterpart of
mvae_tpu/serve_http.py), around serve.py:Sampler:

    python -m mvae_tpu_torch.serve_http --family mnist \
        --checkpoint trained_models/model_best.pth.tar --port 8700 \
        [--device cpu]

Endpoints (JSON request and response):

    GET  /healthz      liveness and the model's identity
    GET  /stats        requests, device calls, rows a call
    POST /sample       {"n": 4, "seed": 0, "condition": {"text": 3}}
    POST /embed        {"inputs": {"image": [...]}}  -> {"mu", "logvar"}
    POST /reconstruct  {"inputs": {"image": [...]}}  -> every modality

Arrays travel as nested JSON lists, or as `{"b64": <base64>, "dtype":
"float32", "shape": [...]}` for bulk data; `"binary": true` in a request
asks for the response in that form too. The outputs are float32, as the
JAX package's are for every family and compute dtype (the posteriors and
the eval-mode decoders' activations are f32).

Dynamic micro-batching: concurrent /embed and /reconstruct requests with
the same modality set are coalesced. A request waits up to --window-ms
while the batcher drains the queue, joins the inputs, makes ONE bucketed
Sampler call and hands each caller its rows. Successive batches run on a
pool of 4 threads, so that their device calls overlap; each leaves the
card by one host copy. /sample is served directly.

Runs on the CUDA card unless --device says otherwise (raises without
one).

--dp N serves over a data-parallel group of N ranks on this node (the
JAX front's data-parallel mesh, mvae_tpu/serve_http.py:370-379): main
spawns N - 1 worker processes, the group meets at a rendezvous file
(gloo where ranks share a card or run on the CPU, NCCL where each has a
card, parallel/distributed.py:choose_backend), and every rank holds a
Sampler(dp=) of the checkpoint. This process, rank 0, runs the front:
each Sampler call, the batcher's and /sample's one at a time
(GroupFront), first broadcasts a header (the endpoint, the modality
names, the shapes and dtypes, n, the seed and the options) and then the
request's tensors; the workers (follow) make the same call, and the
Sampler's all-gather gives every rank the answer. A "stop" header ends
the workers when the server closes.
"""

import argparse
import base64
import datetime
import json
import multiprocessing
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
import torch.distributed as dist

from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models import FAMILIES
from mvae_tpu_torch.parallel.distributed import choose_backend, rank_device
from mvae_tpu_torch.parallel.mesh import DataParallel
from mvae_tpu_torch.serve import Sampler

GROUP_TIMEOUT = datetime.timedelta(minutes=10)

# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------


def decode_array(obj, dtype=None):
    """JSON value -> numpy array. Accepts nested lists, scalars, or the
    binary envelope {"b64", "dtype", "shape"}."""
    if isinstance(obj, dict):
        raw = base64.b64decode(obj["b64"])
        a = np.frombuffer(raw, dtype=np.dtype(obj["dtype"]))
        return a.reshape(obj["shape"]).copy()
    a = np.asarray(obj)
    if dtype is not None and a.dtype != dtype:
        a = a.astype(dtype)
    return a


def encode_array(a, binary=False):
    a = np.asarray(a)
    if binary:
        return {"b64": base64.b64encode(np.ascontiguousarray(a)).decode(),
                "dtype": str(a.dtype), "shape": list(a.shape)}
    return a.tolist()


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype of input_spec."""
    return torch.empty((), dtype=dtype).numpy().dtype


def to_host(tree):
    """A dict of tensors on one device -> numpy arrays, by ONE copy to the
    host (the tensors flattened and joined on the device first)."""
    keys = list(tree)
    flat = torch.cat([tree[k].reshape(-1) for k in keys]).cpu().numpy()
    out, off = {}, 0
    for k in keys:
        n = tree[k].numel()
        out[k] = flat[off:off + n].reshape(tuple(tree[k].shape))
        off += n
    return out


# ---------------------------------------------------------------------------
# dynamic micro-batcher
# ---------------------------------------------------------------------------


class _Pending:
    __slots__ = ("inputs", "n", "event", "result", "error")

    def __init__(self, inputs, n):
        self.inputs = inputs
        self.n = n
        self.event = threading.Event()
        self.result = None
        self.error = None


class MicroBatcher:
    """Coalesce concurrent requests keyed by (endpoint, modality set).

    submit() parks the calling thread; one drain thread wakes every
    `window_s`, joins the parked inputs of each key along the batch axis
    (up to max_batch rows a call), runs `fns[endpoint]` once on a pool of
    `pipeline` threads, and hands each caller its rows. An exception of
    a call reaches every caller of its group.
    """

    def __init__(self, fns, window_s=0.002, max_batch=256, pipeline=4):
        self.fns = fns
        self.window_s = window_s
        self.max_batch = max_batch
        self._lock = threading.Condition()
        self._queues = {}          # key -> [_Pending]
        self._stop = False
        self.device_calls = 0
        self.batched_requests = 0
        self.batch_sizes = []      # rows a device call (bounded)
        self._stats_lock = threading.Lock()
        # successive batches overlap (call N+1 while N's result comes
        # back) instead of waiting on the drain thread
        self._pool = ThreadPoolExecutor(max_workers=max(1, pipeline),
                                        thread_name_prefix="mb")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, endpoint, names, inputs):
        """inputs: dict name -> (n, ...) numpy. Returns the result for
        exactly these n rows."""
        n = next(iter(inputs.values())).shape[0]
        p = _Pending(inputs, n)
        with self._lock:
            if self._stop:
                raise RuntimeError("MicroBatcher is closed")
            self._queues.setdefault((endpoint, names), []).append(p)
            self._lock.notify()
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def close(self):
        with self._lock:
            self._stop = True
            self._lock.notify()
        self._thread.join(timeout=5)
        self._pool.shutdown(wait=True)

    def _loop(self):
        while True:
            with self._lock:
                while not self._queues and not self._stop:
                    self._lock.wait()
                # collect for one whole window so that concurrent arrivals
                # land in this drain, then take the whole backlog (JAX's
                # single wait ends at the next arrival's notify)
                deadline = time.monotonic() + self.window_s
                while not self._stop:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._lock.wait(left)
                queues, self._queues = self._queues, {}
            futures = []
            for (endpoint, names), pend in queues.items():
                i = 0
                while i < len(pend):
                    group, rows = [], 0
                    while i < len(pend) and (
                            not group or rows + pend[i].n <= self.max_batch):
                        group.append(pend[i])
                        rows += pend[i].n
                        i += 1
                    futures.append(self._pool.submit(
                        self._run_group, endpoint, names, group, rows))
            if self._stop:
                for f in futures:
                    f.result()
                return

    def _run_group(self, endpoint, names, group, rows):
        try:
            joined = {k: np.concatenate([p.inputs[k] for p in group])
                      for k in group[0].inputs}
            out = self.fns[endpoint](names, joined)
            with self._stats_lock:
                self.device_calls += 1
                self.batched_requests += len(group)
                if len(self.batch_sizes) < 10000:
                    self.batch_sizes.append(rows)
            off = 0
            for p in group:
                p.result = {k: v[off:off + p.n] for k, v in out.items()}
                off += p.n
        except Exception as e:              # delivered, the pool lives on
            for p in group:
                p.error = e
        finally:
            for p in group:
                p.event.set()


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------


class ServeApp:
    """Routes and stats around a Sampler; transport-agnostic (handle() is
    callable directly; make_server puts it behind HTTP)."""

    def __init__(self, sampler, window_ms=2.0, max_batch=256):
        self.sampler = sampler
        self._spec = sampler.model.input_spec()
        self._dtypes = {k: numpy_dtype(v[1]) for k, v in self._spec.items()}
        self._t0 = time.time()
        self.requests = 0
        # handle() runs on the HTTP server's threads at once
        self._requests_lock = threading.Lock()
        self._batcher = MicroBatcher(
            {"embed": self._embed_batch, "reconstruct": self._recon_batch},
            window_s=window_ms / 1000.0, max_batch=max_batch)

    def _embed_batch(self, names, joined):
        mu, logvar = self.sampler.embed(joined)
        return to_host({"mu": mu, "logvar": logvar})

    def _recon_batch(self, names, joined):
        return to_host(self.sampler.reconstruct(joined))

    def close(self):
        self._batcher.close()

    # -- endpoints ---------------------------------------------------------

    def handle(self, method, path, body):
        """Returns (status, payload dict)."""
        with self._requests_lock:
            self.requests += 1
        if method == "GET" and path == "/healthz":
            m = self.sampler.model
            return 200, {"status": "ok",
                         "model": type(m).__name__,
                         "n_latents": int(m.n_latents),
                         "modalities": list(m.modalities),
                         "uptime_s": round(time.time() - self._t0, 3)}
        if method == "GET" and path == "/stats":
            b = self._batcher
            sizes = b.batch_sizes
            return 200, {"requests": self.requests,
                         "device_calls": b.device_calls,
                         "batched_requests": b.batched_requests,
                         "mean_batch_rows": (float(np.mean(sizes))
                                             if sizes else 0.0),
                         "max_batch_rows": int(max(sizes)) if sizes else 0}
        if method != "POST":
            return 404, {"error": f"no route {method} {path}"}
        try:
            if path == "/sample":
                return 200, self._sample(body or {})
            if path in ("/embed", "/reconstruct"):
                return 200, self._batched(path[1:], body or {})
        except KeyError as e:
            return 400, {"error": f"missing field {e}"}
        except ValueError as e:
            return 400, {"error": str(e)}
        return 404, {"error": f"no route {method} {path}"}

    def _array(self, name, value):
        """A request's array of modality `name`, in its input_spec dtype
        (the binary envelope carries its own)."""
        if name not in self._dtypes:
            raise ValueError(f"unknown modality {name!r}")
        return np.asarray(decode_array(value, self._dtypes[name]),
                          self._dtypes[name])

    def _inputs(self, body):
        raw = body["inputs"]
        if not raw:
            raise ValueError("inputs must name at least one modality")
        inputs = {}
        for k, v in raw.items():
            a = self._array(k, v)
            want = self._spec[k][0]
            if a.shape[1:] != tuple(want):
                raise ValueError(
                    f"{k}: expected (n, {', '.join(map(str, want))}), "
                    f"got {a.shape}")
            inputs[k] = a
        ns = {v.shape[0] for v in inputs.values()}
        if len(ns) != 1:
            raise ValueError(f"ragged batch sizes {sorted(ns)}")
        return inputs

    def _sample(self, body):
        n = int(body.get("n", 1))
        if not 1 <= n <= 4096:
            raise ValueError("n must be in [1, 4096]")
        cond = body.get("condition") or None
        if cond:
            dec = {}
            for k, v in cond.items():
                a = self._array(k, v)
                if a.shape == tuple(self._spec[k][0]):  # an unbatched one
                    a = a[None]
                dec[k] = a
            cond = dec
        out = to_host(self.sampler.sample(n=n, condition=cond,
                                          seed=int(body.get("seed", 0))))
        binary = bool(body.get("binary"))
        return {k: encode_array(v, binary) for k, v in out.items()}

    def _batched(self, endpoint, body):
        inputs = self._inputs(body)
        names = tuple(sorted(inputs))
        out = self._batcher.submit(endpoint, names, inputs)
        binary = bool(body.get("binary"))
        return {k: encode_array(v, binary) for k, v in out.items()}


# ---------------------------------------------------------------------------
# serving over a data-parallel group (--dp)
# ---------------------------------------------------------------------------


def _bcast_header(header, device):
    """Rank 0 sends a JSON header (None elsewhere); every rank returns
    it: two broadcasts, its length and its bytes."""
    raw = (b"" if header is None else json.dumps(header).encode())
    size = torch.tensor([len(raw)], dtype=torch.int64, device=device)
    dist.broadcast(size, src=0)
    buf = torch.zeros(int(size.item()), dtype=torch.uint8, device=device)
    if header is not None:
        buf.copy_(torch.frombuffer(bytearray(raw), dtype=torch.uint8))
    dist.broadcast(buf, src=0)
    return json.loads(bytes(buf.cpu().numpy()).decode())


def _bcast_tensors(header, tensors, device):
    """The header's tensors from rank 0 (tensors elsewhere: None), one
    broadcast each, in the header's order."""
    out = []
    for i, (shape, dtype) in enumerate(zip(header["shapes"],
                                           header["dtypes"])):
        t = (tensors[i].contiguous() if tensors is not None else
             torch.empty(shape, dtype=getattr(torch, dtype), device=device))
        dist.broadcast(t, src=0)
        out.append(t)
    return out


def _call(sampler, header, tensors):
    """The Sampler call a header names, on the broadcast tensors."""
    op = header["op"]
    named = dict(zip(header["names"], tensors))
    if op == "sample":
        return sampler.sample(n=header["n"], condition=named or None,
                              seed=header["seed"], **header["options"])
    return getattr(sampler, op)(named)


class GroupFront:
    """Rank 0's face of a Sampler(dp=) to the ServeApp: each endpoint
    call, one at a time, is broadcast to the workers (follow) before it
    is made here."""

    warmup = Sampler.warmup

    def __init__(self, sampler):
        self.sampler = sampler
        self.model = sampler.model
        self.device = sampler.device
        self._lock = threading.Lock()

    def _bucket_m(self, n):
        return self.sampler._bucket_m(n)

    def _run(self, op, named, n=0, seed=0, options=None):
        tensors = [torch.as_tensor(v, device=self.device)
                   for v in named.values()]
        header = dict(op=op, names=list(named), n=n, seed=seed,
                      options=options or {},
                      shapes=[list(t.shape) for t in tensors],
                      dtypes=[str(t.dtype).split(".")[-1] for t in tensors])
        with self._lock:
            _bcast_header(header, self.device)
            return _call(self.sampler, header,
                         _bcast_tensors(header, tensors, self.device))

    def sample(self, n=1, condition=None, seed=0, **infer_options):
        options = {k: torch.as_tensor(v).tolist()
                   for k, v in infer_options.items()}
        return self._run("sample", condition or {}, n, seed, options)

    def embed(self, inputs):
        return self._run("embed", inputs)

    def reconstruct(self, inputs):
        return self._run("reconstruct", inputs)

    def close(self):
        """End the workers' loops."""
        with self._lock:
            _bcast_header({"op": "stop"}, self.device)


def follow(sampler):
    """A worker's loop: make each call rank 0 broadcasts, until "stop"."""
    while True:
        header = _bcast_header(None, sampler.device)
        if header["op"] == "stop":
            return
        _call(sampler, header, _bcast_tensors(header, None, sampler.device))


def _init_rank(rank, world, store, device):
    """Join the serving group as `rank`: (its device, its DataParallel,
    the backend, why that backend)."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend, why = choose_backend(dev, world)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    return dev, DataParallel(dist.group.WORLD, rank, world), backend, why


def _worker_main(rank, world, store, ns):
    dev, dp, _, _ = _init_rank(rank, world, store, ns.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    try:
        follow(Sampler.from_checkpoint(ns.checkpoint, device=dev,
                                       family=ns.family, dp=dp))
    finally:
        dist.destroy_process_group()


def start_group(ns, tmp):
    """Spawn the ns.dp - 1 workers and join the group as rank 0: (the
    workers, this rank's device, its DataParallel)."""
    store = os.path.join(tmp, "store")
    ctx = multiprocessing.get_context("spawn")
    workers = [ctx.Process(target=_worker_main, args=(r, ns.dp, store, ns),
                           daemon=True) for r in range(1, ns.dp)]
    for w in workers:
        w.start()
    dev, dp, backend, why = _init_rank(0, ns.dp, store, ns.device)
    print(f"serving over a {ns.dp}-device data-parallel mesh (backend "
          f"{backend}: {why})", flush=True)
    return workers, dev, dp


def stop_group(front, workers, timeout_s=60):
    """Stop the workers (a "stop" header; front None: rank 0 never served,
    so they are killed), wait for them, leave the group; a worker that
    outlives timeout_s is killed."""
    try:
        if front is not None:
            front.close()
            for w in workers:
                w.join(timeout_s)
    finally:
        for w in workers:
            if w.is_alive():
                w.kill()
                w.join(10)
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# HTTP transport
# ---------------------------------------------------------------------------


def make_server(app, host="127.0.0.1", port=0):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, status, payload):
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            status, payload = app.handle("GET", self.path, None)
            self._reply(status, payload)

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:              # JSONDecodeError included
                self._reply(400, {"error": "invalid JSON body"})
                return
            status, payload = app.handle("POST", self.path, body)
            self._reply(status, payload)

        def log_message(self, *a):          # quiet
            pass

    class Server(ThreadingHTTPServer):
        # the default accept backlog (5) drops connections under a burst
        # of concurrent clients, the traffic micro-batching is for
        request_queue_size = 128
        daemon_threads = True

    return Server((host, port), Handler)


def warmup_buckets(max_batch):
    """The batch buckets a drained batch of up to max_batch rows reaches:
    1 to max_batch by powers of two."""
    out, m = [], 1
    while m < max_batch:
        out.append(m)
        m *= 2
    return out + [max_batch]


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="a reference-layout .pth.tar")
    ap.add_argument("--family", required=True, choices=sorted(FAMILIES),
                    help="the checkpoint's family (checked against it)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="micro-batching window for /embed and /reconstruct")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip running every endpoint at startup")
    ap.add_argument("--device", default=None,
                    help="torch device [default: the CUDA card; raises "
                         "without one]")
    ap.add_argument("--dp", type=int, default=1,
                    help="serve over a data-parallel group of N ranks on "
                         "this node (batch buckets round up to a multiple "
                         "of N)")
    return ap


def main(argv=None):
    ap = parser()
    ns = ap.parse_args(argv)
    if ns.dp < 1:
        ap.error("--dp takes a group size of at least 1")
    with tempfile.TemporaryDirectory(prefix="serve_http_") as tmp:
        workers, dp = [], None
        if ns.dp > 1:
            workers, device, dp = start_group(ns, tmp)
        else:
            device = resolve_device(ns.device)
        front = None
        try:
            sampler = Sampler.from_checkpoint(
                ns.checkpoint, device=device, family=ns.family, dp=dp)
            front = sampler if dp is None else GroupFront(sampler)
            serve(front, ns)
        finally:
            if dp is not None:
                stop_group(front, workers)


def serve(front, ns):
    """Warm the endpoints up and serve HTTP until interrupted."""
    if not ns.no_warmup:
        t = time.time()
        print("warming up the endpoints ...", flush=True)
        front.warmup(buckets=warmup_buckets(ns.max_batch))
        print(f"warmup done in {time.time() - t:.1f}s", flush=True)
    app = ServeApp(front, window_ms=ns.window_ms, max_batch=ns.max_batch)
    srv = make_server(app, ns.host, ns.port)
    print(f"serving {ns.family} on http://{ns.host}:{srv.server_address[1]}",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        app.close()
        srv.server_close()


if __name__ == "__main__":
    main()
