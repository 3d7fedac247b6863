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
one). --dp (serving over a data-parallel group of devices) is refused:
the port trains data-parallel (mvae_tpu_torch/parallel/) but does not
serve so yet.
"""

import argparse
import base64
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from mvae_tpu_torch.device import resolve_device
from mvae_tpu_torch.models import FAMILIES
from mvae_tpu_torch.serve import Sampler

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
                    help="not ported yet (serving over N devices): refused "
                         "above 1")
    return ap


def main(argv=None):
    ap = parser()
    ns = ap.parse_args(argv)
    if ns.dp != 1:
        ap.error("--dp is not ported yet: the port serves on one device")
    device = resolve_device(ns.device)
    sampler = Sampler.from_checkpoint(ns.checkpoint, device=device,
                                      family=ns.family)
    if not ns.no_warmup:
        t = time.time()
        print("warming up the endpoints ...", flush=True)
        sampler.warmup(buckets=warmup_buckets(ns.max_batch))
        print(f"warmup done in {time.time() - t:.1f}s", flush=True)
    app = ServeApp(sampler, window_ms=ns.window_ms, max_batch=ns.max_batch)
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
