"""The port's HTTP serving front (mvae_tpu_torch/serve_http.py) against
the JAX package's (mvae_tpu/serve_http.py) on one MnistMVAE(8)'s weights,
transplanted with utils/weights.py:state_dict_from_jax: the wire format,
every endpoint (/embed and /reconstruct at rtol 1e-5, in JSON and in the
binary form), the 400s and 404s, the micro-batcher's coalescing, its
max_batch and its delivery of errors, one real HTTP round trip, the load
generator, Sampler.warmup(conditions=...) and the CLI's refusals. /sample draws from
torch's generators, not jax.random, so its values are held to shapes,
ranges and determinism per seed, not to JAX's."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvae_tpu_torch.serve_http as serve_http
from mvae_tpu.models.mnist import MnistMVAE as JaxMnist
from mvae_tpu.serve import Sampler as JaxSampler
from mvae_tpu.serve_http import ServeApp as JaxServeApp
from mvae_tpu.serve_http import decode_array as jax_decode_array
from mvae_tpu.serve_http import encode_array as jax_encode_array
from mvae_tpu_torch.data.mnist import synthetic_mnist
from mvae_tpu_torch.models import MnistMVAE
from mvae_tpu_torch.serve import Sampler
from mvae_tpu_torch.serve_http import (
    MicroBatcher, ServeApp, decode_array, encode_array, make_server,
    to_host, warmup_buckets)
from tests.test_torch_port_families import port_family

L = 8
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The port's side on one intra-op thread, restored after (see
    tests/test_torch_port_families.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_sampler(compute_dtype=None):
    jm = JaxMnist(L, compute_dtype=compute_dtype)
    params, state = jm.init(jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    return JaxSampler(jm, params, state), params, state


@pytest.fixture(scope="module")
def samplers():
    """(the port's Sampler, JAX's Sampler) over the same weights."""
    js, params, state = jax_sampler()
    pm = port_family("mnist", params, state)
    return Sampler(pm, device="cpu"), js


@pytest.fixture
def apps(samplers):
    a, b = ServeApp(samplers[0], window_ms=1.0), JaxServeApp(samplers[1])
    yield a, b
    a.close()
    b.close()


def _imgs(n, seed=0):
    imgs, _ = synthetic_mnist(n, seed=seed)
    return imgs.reshape(n, 784).astype(np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


# --------------------------------------------------------------------------
# the wire format
# --------------------------------------------------------------------------

@pytest.mark.parametrize("a", [
    np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
    np.arange(5, dtype=np.int32), np.float32(0.25),
    np.linspace(0, 1, 12, dtype=np.float32).reshape(2, 2, 3)],
    ids=["f32", "int32", "scalar", "rank3"])
def test_wire_format_round_trips_and_is_jaxs(a):
    for binary in (False, True):
        got = encode_array(a, binary)
        assert json.dumps(got) == json.dumps(jax_encode_array(a, binary))
        back = decode_array(json.loads(json.dumps(got)), np.asarray(a).dtype)
        assert back.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(back, a)
        np.testing.assert_array_equal(back, jax_decode_array(got))


def test_to_host_is_one_copy(monkeypatch):
    copies = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t: copies.append(t.shape) or real(t))
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2, 1, 2)}
    out = to_host(tree)
    assert len(copies) == 1
    for k, v in tree.items():
        np.testing.assert_array_equal(out[k], v.numpy())


# --------------------------------------------------------------------------
# the endpoints against JAX's
# --------------------------------------------------------------------------

def test_healthz_stats_and_unknown_routes(apps):
    app, japp = apps
    status, h = app.handle("GET", "/healthz", None)
    _, jh = japp.handle("GET", "/healthz", None)
    assert status == 200 and h["status"] == "ok"
    assert {k: h[k] for k in ("model", "n_latents", "modalities")} == {
        k: jh[k] for k in ("model", "n_latents", "modalities")}
    for method, path in (("GET", "/nope"), ("POST", "/nope"),
                         ("GET", "/embed"), ("PUT", "/sample")):
        assert app.handle(method, path, {})[0] == 404, (method, path)
    status, s = app.handle("GET", "/stats", None)
    assert status == 200 and s["requests"] == 6
    assert s["device_calls"] == 0 and s["mean_batch_rows"] == 0.0


@pytest.mark.parametrize("binary", [False, True])
def test_embed_matches_jax_and_the_direct_call(apps, samplers, binary,
                                               monkeypatch):
    """The response equals JAX's ServeApp's at rtol 1e-5 and the direct
    Sampler call bit for bit (one request: the same bucket); the outputs
    leave for the host by one copy."""
    app, japp = apps
    x = _imgs(3)
    body = {"inputs": {"image": encode_array(x, binary)}, "binary": binary}
    copies = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t: copies.append(1) or real(t))
    status, out = app.handle("POST", "/embed", body)
    monkeypatch.undo()
    assert status == 200 and len(copies) == 1
    _, jout = japp.handle("POST", "/embed", body)
    mu, lv = samplers[0].embed({"image": x})
    for k, direct in (("mu", mu), ("logvar", lv)):
        got = decode_array(out[k], np.float32)   # a list's floats are f32's
        assert got.dtype == np.float32 and got.shape == (3, L)
        _close(got, decode_array(jout[k]), k)
        np.testing.assert_array_equal(got, direct.numpy())


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("names", [("image",), ("text",), ("image", "text")])
def test_reconstruct_matches_jax(apps, binary, names):
    app, japp = apps
    x = {"image": _imgs(2, seed=3), "text": np.array([4, 7], np.int32)}
    body = {"inputs": {k: encode_array(x[k], binary) for k in names},
            "binary": binary}
    status, out = app.handle("POST", "/reconstruct", body)
    jstatus, jout = japp.handle("POST", "/reconstruct", body)
    assert status == jstatus == 200 and sorted(out) == sorted(jout)
    for k in out:
        got = decode_array(out[k])
        assert got.shape == np.asarray(decode_array(jout[k])).shape
        _close(got, decode_array(jout[k]), k)


def test_bf16_outputs_travel_in_jaxs_dtypes():
    """A bf16 model's responses carry the dtypes JAX's ServeApp gives for
    the same model and compute dtype (float32: numpy has no bfloat16)."""
    js, params, state = jax_sampler(jnp.bfloat16)
    pm = port_family("mnist", params, state, torch.bfloat16)
    app, japp = ServeApp(Sampler(pm, device="cpu")), JaxServeApp(js)
    try:
        x = {"image": encode_array(_imgs(2), True)}
        for path, body in (("/embed", {"inputs": x}),
                           ("/reconstruct", {"inputs": x}),
                           ("/sample", {"n": 2}),
                           ("/sample", {"n": 2, "condition": {"text": 1}})):
            body = dict(body, binary=True)
            out, jout = app.handle("POST", path, body)[1], japp.handle(
                "POST", path, body)[1]
            assert {k: v["dtype"] for k, v in out.items()} == {
                k: v["dtype"] for k, v in jout.items()} != {}, path
    finally:
        app.close()
        japp.close()


def test_sample_prior_and_scalar_condition(apps):
    """Shapes and ranges of the prior and a scalar text condition; one
    seed gives one draw, two seeds two."""
    app, _ = apps
    outs = {}
    for key, body in (("prior", {"n": 3, "seed": 5}),
                      ("prior again", {"n": 3, "seed": 5}),
                      ("prior seed 6", {"n": 3, "seed": 6}),
                      ("text", {"n": 3, "seed": 5,
                                "condition": {"text": 4}}),
                      ("text batched", {"n": 3, "seed": 5,
                                        "condition": {"text": [4]}})):
        status, out = app.handle("POST", "/sample", body)
        assert status == 200, out
        outs[key] = {k: np.asarray(v) for k, v in out.items()}
        assert outs[key]["image"].shape == (3, 784)
        assert outs[key]["text"].shape == (3, 10)
        for v in outs[key].values():
            assert np.isfinite(v).all() and v.min() >= 0 and v.max() <= 1
        np.testing.assert_allclose(outs[key]["text"].sum(-1), 1.0,
                                   rtol=1e-5)
    np.testing.assert_array_equal(outs["prior"]["image"],
                                  outs["prior again"]["image"])
    assert not np.array_equal(outs["prior"]["image"],
                              outs["prior seed 6"]["image"])
    np.testing.assert_array_equal(outs["text"]["image"],
                                  outs["text batched"]["image"])
    assert not np.array_equal(outs["prior"]["image"], outs["text"]["image"])


def test_request_validation_is_jaxs(apps):
    """Every malformed request: a 400 with JAX's message."""
    app, japp = apps
    for path, body, frag in [
            ("/embed", {"inputs": {}}, "at least one"),
            ("/embed", {}, "missing field"),
            ("/embed", {"inputs": {"nope": [[0.0]]}}, "unknown modality"),
            ("/embed", {"inputs": {"image": [[0.0, 1.0]]}}, "expected"),
            ("/reconstruct", {"inputs": {"image": _imgs(2).tolist(),
                                         "text": [1, 2, 3]}}, "ragged"),
            ("/sample", {"n": 0}, "n must be"),
            ("/sample", {"n": 4097}, "n must be"),
            ("/sample", {"condition": {"nope": 1}}, "unknown modality")]:
        status, out = app.handle("POST", path, body)
        jstatus, jout = japp.handle("POST", path, body)
        assert status == jstatus == 400, (path, body)
        assert frag in out["error"] and out["error"] == jout["error"]


# --------------------------------------------------------------------------
# the micro-batcher
# --------------------------------------------------------------------------

def test_concurrent_requests_coalesce(samplers):
    """16 concurrent /embed requests of 2 rows inside one 80 ms window
    make fewer device calls, and each caller gets its own rows: the
    direct Sampler call's within rtol 1e-5 (a coalesced batch may land in
    another bucket, whose matmuls may sum in another order)."""
    sampler = samplers[0]
    app = ServeApp(sampler, window_ms=80.0)
    try:
        xs = [_imgs(2, seed=i) for i in range(16)]
        results = [None] * 16

        def hit(i):
            status, out = app.handle(
                "POST", "/embed",
                {"inputs": {"image": encode_array(xs[i], binary=True)},
                 "binary": True})
            assert status == 200
            results[i] = decode_array(out["mu"])

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        calls = app._batcher.device_calls
        assert 1 <= calls < 16, calls
        assert sum(app._batcher.batch_sizes) == 32
        assert app.handle("GET", "/stats", None)[1]["device_calls"] == calls
        for i in range(16):
            _close(results[i], sampler.embed({"image": xs[i]})[0], str(i))
    finally:
        app.close()


def test_microbatcher_max_batch_and_errors():
    """Groups split at max_batch rows; an endpoint's exception reaches
    every caller of its group, and the loop lives on; a closed batcher
    refuses at once."""
    calls = []

    def fn(names, joined):
        n = next(iter(joined.values())).shape[0]
        calls.append(n)
        if n == 0:
            raise ValueError("boom")
        return {"y": joined["x"] * 2}

    b = MicroBatcher({"f": fn}, window_s=0.05, max_batch=4)
    try:
        xs = [np.full((3, 2), i, np.float32) for i in range(4)]
        results = [None] * 4

        def hit(i):
            results[i] = b.submit("f", ("x",), {"x": xs[i]})

        ts = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        for i in range(4):
            np.testing.assert_array_equal(results[i]["y"], xs[i] * 2)
        assert calls and max(calls) <= 4      # 3 + 3 > 4: one a call

        errors = []

        def bad():
            try:
                b.submit("f", ("x",), {"x": np.zeros((0, 2), np.float32)})
            except ValueError as e:
                errors.append(str(e))

        t = threading.Thread(target=bad)
        t.start()
        t.join(timeout=5)
        assert not t.is_alive() and errors == ["boom"]
        out = b.submit("f", ("x",), {"x": np.ones((1, 2), np.float32)})
        np.testing.assert_array_equal(out["y"], np.full((1, 2), 2.0))
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("f", ("x",), {"x": np.ones((1, 2), np.float32)})


def test_window_holds_for_its_whole_length():
    """Requests that arrive one after another inside one window land in
    one call: the drain waits out the window, not the next arrival."""
    calls = []
    b = MicroBatcher({"f": lambda names, j: calls.append(len(j["x"])) or {
        "y": j["x"]}}, window_s=0.5)
    try:
        ts = [threading.Thread(target=b.submit, args=(
            "f", ("x",), {"x": np.zeros((1, 1), np.float32)}))
            for _ in range(3)]
        for t in ts:
            t.start()
            threading.Event().wait(0.05)
        for t in ts:
            t.join(timeout=10)
        assert calls == [3]
    finally:
        b.close()


def test_launch_counts_lose_no_update_across_threads():
    """The batcher's pool calls the ops from several threads at once: the
    wrappers' launch counters (ops/_cuda.py:launched) must lose no
    count, with the interpreter switching threads as often as it can."""
    import sys

    from mvae_tpu_torch.ops import _cuda

    def wrapper():
        pass

    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _cuda.launched(wrapper) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16 * 2000


# --------------------------------------------------------------------------
# transport, warmup, the CLI
# --------------------------------------------------------------------------

def test_http_round_trip(samplers):
    """Real sockets: a ThreadingHTTPServer on an ephemeral port answers
    /healthz and /embed through urllib, and a malformed body with a 400
    that leaves the server up."""
    app = ServeApp(samplers[0], window_ms=1.0)
    srv = make_server(app, "127.0.0.1", 0)
    assert srv.request_queue_size == 128
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert json.load(r)["status"] == "ok"
        x = _imgs(2)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/embed",
            data=json.dumps({"inputs": {"image": x.tolist()}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.load(r)
        np.testing.assert_array_equal(np.asarray(out["mu"], np.float32),
                                      samplers[0].embed({"image": x})[0])
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/embed", data=b"{not json",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/stats", timeout=10) as r:
            assert json.load(r)["requests"] == 3
    finally:
        srv.shutdown()
        srv.server_close()
        app.close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_load_generator_runs_its_clients_in_a_process_of_their_own(
        samplers):
    """tools/serve_http_bench.py: the windows in turns (0, 2, 2, 0), each
    burst's requests all answered by the clients of one spawned process,
    its device calls and rows a call accounted, and that process gone
    after the bench."""
    import multiprocessing

    from mvae_tpu_torch.tools import serve_http_bench
    runs = serve_http_bench.bench(samplers[0], [0.0, 2.0], 3, 2, 1)
    assert [r["window_ms"] for r in runs] == [0.0, 2.0, 2.0, 0.0]
    for r in runs:
        assert r["requests"] == 6 and r["rows"] == 1
        assert 1 <= r["device_calls"] <= 6
        assert r["mean_rows_per_call"] == 6 / r["device_calls"]
        assert 0 < r["p50_ms"] <= r["p95_ms"]
        assert r["req_per_s"] == 6 / r["wall_s"]
    assert not multiprocessing.active_children()


def test_warmup_conditions(samplers, monkeypatch):
    """warmup(conditions=...) runs the prior sample and, for each modality
    set, the conditioned sample, embed and reconstruct at every bucket;
    without conditions, each single modality."""
    sampler = samplers[0]
    seen = []
    for name in ("sample", "embed", "reconstruct"):
        real = getattr(Sampler, name)

        def spy(self, *a, _name=name, _real=real, **kw):
            if _name == "sample":
                seen.append(("sample", kw["n"],
                             tuple(sorted(kw.get("condition") or ()))))
            else:
                x = a[0]
                seen.append((_name, len(next(iter(x.values()))),
                             tuple(sorted(x))))
            return _real(self, *a, **kw)

        monkeypatch.setattr(Sampler, name, spy)
    sampler.warmup(buckets=(1, 3), conditions=[("image", "text")])
    want = []
    for m in (1, 4):
        want += [("sample", m, ()), ("sample", m, ("image", "text")),
                 ("embed", m, ("image", "text")),
                 ("reconstruct", m, ("image", "text"))]
    assert seen == want
    seen.clear()
    sampler.warmup(buckets=(2,))
    assert seen == [("sample", 2, ())] + [
        (f, 2, (k,)) for k in ("image", "text")
        for f in ("sample", "embed", "reconstruct")]


def test_warmup_buckets_reach_max_batch():
    assert warmup_buckets(256) == [1, 2, 4, 8, 16, 32, 64, 128, 256]
    assert warmup_buckets(100) == [1, 2, 4, 8, 16, 32, 64, 100]
    assert warmup_buckets(1) == [1]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "model_best.pth.tar"
    model = MnistMVAE(L, device="cpu")
    torch.save({"state_dict": model.state_dict(), "n_latents": L,
                "model": "mnist"}, path)
    return str(path)


def test_main_serves_the_checkpoint(checkpoint, monkeypatch, capsys):
    """main on --device cpu: the family checked, warmup over the buckets
    1 to --max-batch, the server started, and on its end the app and the
    socket closed."""
    warmed, events = [], []

    class FakeServer:
        server_address = ("127.0.0.1", 4321)

        def serve_forever(self):
            events.append("serve")
            raise KeyboardInterrupt

        def server_close(self):
            events.append("server_close")

    made = []
    monkeypatch.setattr(Sampler, "warmup", lambda self, buckets, **kw:
                        warmed.append(list(buckets)))
    monkeypatch.setattr(serve_http, "make_server", lambda app, host, port:
                        made.append((app, host, port)) or FakeServer())
    serve_http.main(["--checkpoint", checkpoint, "--family", "mnist",
                     "--device", "cpu", "--max-batch", "8", "--port", "0"])
    assert warmed == [[1, 2, 4, 8]]
    app, host, port = made[0]
    assert (host, port) == ("127.0.0.1", 0) and events == [
        "serve", "server_close"]
    assert type(app.sampler.model) is MnistMVAE
    with pytest.raises(RuntimeError, match="closed"):
        app._batcher.submit("embed", ("image",), {"image": _imgs(1)})
    assert "serving mnist on http://127.0.0.1:4321" in capsys.readouterr().out


def test_main_refuses_dp_and_another_family(checkpoint, capsys):
    """A group size below 1 and a checkpoint of another family are refused
    (--dp 2 serves: test_main_serves_over_a_dp_group_as_one_device)."""
    with pytest.raises(SystemExit):
        serve_http.main(["--checkpoint", checkpoint, "--family", "mnist",
                         "--device", "cpu", "--dp", "0"])
    assert "--dp takes a group size of at least 1" in capsys.readouterr().err
    with pytest.raises(ValueError, match="holds a mnist model, not "
                                         "fashionmnist"):
        serve_http.main(["--checkpoint", checkpoint, "--family",
                         "fashionmnist", "--device", "cpu", "--no-warmup"])
    with pytest.raises(SystemExit):
        serve_http.main(["--checkpoint", checkpoint, "--family", "nope",
                         "--device", "cpu"])


def _served(checkpoint, monkeypatch, dp):
    """One request at each endpoint through main's app with --dp dp (the
    server faked: its serve_forever sends them): name -> (status,
    payload)."""
    got = {}
    image = _imgs(3, seed=5).tolist()

    class FakeServer:
        server_address = ("127.0.0.1", 4321)

        def __init__(self, app):
            self.app = app

        def serve_forever(self):
            h = self.app.handle
            got["embed"] = h("POST", "/embed", {"inputs": {"image": image}})
            got["reconstruct"] = h("POST", "/reconstruct", {"inputs": {
                "image": image, "text": [1, 2, 3]}})
            got["sample"] = h("POST", "/sample", {"n": 5, "seed": 3})
            got["sample_cond"] = h("POST", "/sample", {
                "n": 3, "seed": 4, "condition": {"text": 7}})
            raise KeyboardInterrupt

        def server_close(self):
            pass

    monkeypatch.setattr(serve_http, "make_server",
                        lambda app, host, port: FakeServer(app))
    serve_http.main(["--checkpoint", checkpoint, "--family", "mnist",
                     "--device", "cpu", "--max-batch", "4", "--dp", str(dp)])
    return got


def test_main_serves_over_a_dp_group_as_one_device(checkpoint, monkeypatch,
                                                   capsys):
    """--dp 2 spawns a worker rank (gloo on the CPU), prints JAX's mesh
    line, warms up through the group and answers every endpoint with one
    device's values (each rank's rows of the bucket, gathered); on the
    server's end the worker stops and the group is left."""
    one = _served(checkpoint, monkeypatch, 1)
    two = _served(checkpoint, monkeypatch, 2)
    assert "serving over a 2-device data-parallel mesh" in \
        capsys.readouterr().out
    assert not torch.distributed.is_initialized()
    for name, (status, payload) in one.items():
        assert status == two[name][0] == 200, (name, two[name])
        assert set(payload) == set(two[name][1])
        for k, v in payload.items():
            _close(two[name][1][k], v, f"{name} {k}")


def test_bucket_rounds_up_to_a_multiple_of_dp():
    """Sampler(dp=) buckets as mvae_tpu/serve.py:135-141: the next power
    of two, rounded up to a multiple of the group's size."""
    from mvae_tpu_torch.parallel.mesh import DataParallel
    model = MnistMVAE(L, device="cpu")
    for world, want in ((1, [1, 2, 4, 4, 8]), (3, [3, 3, 6, 6, 9]),
                        (6, [6, 6, 6, 6, 12])):
        s = Sampler(model, device="cpu", dp=DataParallel(None, 0, world))
        assert [s._bucket_m(n) for n in (1, 2, 3, 4, 5)] == want
