"""The port's profiler spans (utils/profiling.py:span) on the CPU, at small
widths in f32:

  - with no capture running, a CelebA window, a celeba19 step with its
    sampled terms and an IWAE batch never call record_function;
  - under a CPU torch.profiler capture the same calls record the stage
    spans, nested as the train step and the scorer run them, one
    mvae.engine.decode.stats span for each forward-alone call of the
    step's decode plan and none on the one-batch decode;
  - a data-parallel step over one gloo rank records mvae.train.allreduce;
  - every name keeps the naming rules.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from mvae_tpu_torch.core import subsets
from mvae_tpu_torch.core.loglike import iwae_log_marginal
from mvae_tpu_torch.models import Celeba19MVAE, CelebaMVAE
from mvae_tpu_torch.parallel.mesh import data_parallel
from mvae_tpu_torch.train.loop import (
    decode_batch, make_multi_train_step, make_train_step)
from mvae_tpu_torch.utils import profiling

L = 8
B = 2
K = 2
MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3

STEP = ["mvae.train.gather", "mvae.train.noise", "mvae.train.adam",
        "mvae.engine.elbo", "mvae.train.backward", "mvae.train.adam"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n, seed=0):
    """n CelebA rows: uint8 pixels and 0/1 attributes."""
    gen = torch.Generator().manual_seed(seed)
    return {"image": torch.randint(0, 256, (n, 64, 64, 3), generator=gen,
                                   dtype=torch.uint8),
            "attrs": (torch.rand((n, 18), generator=gen) < 0.3).float()}


def celeba_window(support=None):
    """A K-step window of a CelebaMVAE(L): (run, the step's plan)."""
    model = CelebaMVAE(L, device="cpu")
    multi = make_multi_train_step(
        model, MASKS, LAMBDAS, lr=1e-4, device="cpu",
        generator=torch.Generator().manual_seed(0), recon_support=support)
    data = _data(4 * B)
    idxs = torch.arange(K * B).view(K, B)
    return (lambda: multi(data, idxs, torch.ones(K))), multi.plan


def celeba19_step(support=None):
    """One celeba19 step with its 21 terms (one sampled) given per call:
    (run, the step's plan)."""
    model = Celeba19MVAE(L, device="cpu")
    masks, lambdas = subsets.celeba19_step_terms(
        np.random.default_rng(3), 1, 18, 1.0, 10.0)
    step = make_train_step(
        model, None, None, lr=1e-4, device="cpu",
        generator=torch.Generator().manual_seed(0),
        recon_support=(subsets.celeba19_recon_support(1) if support is None
                       else support))
    batch = _data(B)
    terms = dict(masks=torch.tensor(masks), lambdas=torch.tensor(lambdas))
    return (lambda: step(batch, 1.0, **terms)), step.plan


def iwae_batch():
    model = CelebaMVAE(L, device="cpu")
    batch = decode_batch(_data(B), torch.float32)
    gen = torch.Generator().manual_seed(0)
    return (lambda: iwae_log_marginal(model, batch, [1.0, 0.0], ["image"], 3,
                                      generator=gen)), None


CASES = {"celeba": celeba_window, "celeba19": celeba19_step,
         "iwae": iwae_batch}


def recorded(run):
    """run() under a CPU capture: the mvae.* spans as [name, start, end,
    parent name or None], in start order (parent: the innermost mvae.*
    span that holds it)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = sorted(
        ([k.name(), k.start_ns(), k.start_ns() + k.duration_ns(), None]
         for k in prof.profiler.kineto_results.events()
         if k.name().startswith(profiling.SPAN_PREFIX)),
        key=lambda s: (s[1], -s[2]))
    for i, s in enumerate(spans):
        holders = [p for p in spans[:i] if p[1] <= s[1] and s[2] <= p[2]]
        if holders:
            s[3] = max(holders, key=lambda p: p[1])[0]
    return spans


def children(spans, parent):
    return [s[0] for s in spans if s[3] == parent]


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_capture_calls_no_record_function(case, monkeypatch):
    """With no profiler recording a span is the shared no-op: the train
    window, celeba19's step and the IWAE run with record_function made to
    raise."""
    run, _ = CASES[case]()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no capture")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("mvae.train.step") is profiling.span(
        "mvae.engine.loss")
    out = run()
    assert torch.isfinite(out[0] if isinstance(out, tuple) else out).all()


def test_celeba_window_spans_nest_as_the_step_runs():
    """A CelebA window: one window span over K step spans; each step's
    stages in order, the engine's stages inside its ELBO, no span of the
    scorer."""
    run, plan = celeba_window()
    spans = recorded(run)
    assert children(spans, None) == ["mvae.train.window"]
    assert children(spans, "mvae.train.window") == ["mvae.train.step"] * K
    assert children(spans, "mvae.train.step") == STEP * K
    calls = [c for g in plan for c in g.calls]
    decode = ["mvae.engine.decode.train" if c.grad
              else "mvae.engine.decode.stats" for c in calls]
    assert children(spans, "mvae.engine.elbo") == (
        ["mvae.engine.encode", "mvae.engine.fuse"] + decode
        + ["mvae.engine.loss", "mvae.engine.commit"]) * K
    assert not any(s[0].startswith("mvae.score.") for s in spans)


@pytest.mark.parametrize("case", ["celeba", "celeba19"])
def test_one_stats_span_per_forward_alone_call(case):
    """mvae.engine.decode.stats: one span a step for each call of the plan
    that runs forward alone (BN statistics), mvae.engine.decode.train one
    for each call with autograd; the one-batch decode (an all-ones
    support) opens one decode.train span and no stats span."""
    make = CASES[case]
    run, plan = make()
    steps = K if case == "celeba" else 1
    calls = [c for g in plan for c in g.calls]
    names = [s[0] for s in recorded(run)]
    stats = sum(not c.grad for c in calls)
    assert stats >= 1
    assert names.count("mvae.engine.decode.stats") == stats * steps
    assert names.count("mvae.engine.decode.train") == (
        (len(calls) - stats) * steps)
    t = 3 if case == "celeba" else 21
    m = 2 if case == "celeba" else 19
    run, plan = make(np.ones((t, m), np.float32))
    assert plan is None
    names = [s[0] for s in recorded(run)]
    assert "mvae.engine.decode.stats" not in names
    assert names.count("mvae.engine.decode.train") == steps


def test_celeba19_step_spans():
    """celeba19's step: the step's stages, then in its ELBO the encode,
    the fuse, the plan's decode calls in order, the loss and the
    commit."""
    run, plan = celeba19_step()
    spans = recorded(run)
    assert children(spans, None) == ["mvae.train.step"]
    assert children(spans, "mvae.train.step") == STEP
    inner = children(spans, "mvae.engine.elbo")
    assert inner[:2] == ["mvae.engine.encode", "mvae.engine.fuse"]
    assert inner[-2:] == ["mvae.engine.loss", "mvae.engine.commit"]
    assert inner[2:-2] == [
        "mvae.engine.decode.train" if c.grad else "mvae.engine.decode.stats"
        for g in plan for c in g.calls]


def test_iwae_spans():
    """An IWAE batch: one batch span over its encode, its fuse, each
    chunk's decode and weights, and the final weights."""
    run, _ = iwae_batch()
    spans = recorded(run)
    assert children(spans, None) == ["mvae.score.batch"]
    assert children(spans, "mvae.score.batch") == [
        "mvae.score.encode", "mvae.score.fuse", "mvae.score.decode",
        "mvae.score.weights", "mvae.score.weights"]
    assert not any(s[0].startswith(("mvae.train.", "mvae.engine."))
                   for s in spans)


def test_dp_step_records_allreduce(tmp_path):
    """Under dp (one gloo rank) the gradients' average opens
    mvae.train.allreduce between the backward and Adam's step."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        model = CelebaMVAE(L, device="cpu")
        step = make_train_step(
            model, MASKS, LAMBDAS, lr=1e-4, device="cpu",
            generator=torch.Generator().manual_seed(0),
            dp=data_parallel(B))
        batch = _data(B)
        spans = recorded(lambda: step(batch, 1.0))
    finally:
        dist.destroy_process_group()
    assert children(spans, "mvae.train.step") == (
        STEP[:-1] + ["mvae.train.allreduce", "mvae.train.adam"])


def test_span_names_keep_the_rules():
    """Every name the port opens is in SPANS, and every name in SPANS
    starts with mvae., not with cu or bench., and holds no conv; each is
    recorded by one of the runs above."""
    seen = set()
    for make in CASES.values():
        seen |= {s[0] for s in recorded(make()[0])}
    assert seen <= set(profiling.SPANS)
    assert set(profiling.SPANS) - seen == {"mvae.train.allreduce"}
    for name in profiling.SPANS:
        assert name.startswith(profiling.SPAN_PREFIX)
        assert not name.startswith(("cu", "bench."))
        assert "conv" not in name.lower()
