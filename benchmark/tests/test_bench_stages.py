"""The program's own spans in a traced capture (harness/stages.py and the
readers of metrics/ that read them), on made-up events in the style of
test_bench_trace.py: the existing readers read what they read without the
spans, idle gaps inside a span take its name, and the engine's host
time is read from its span."""

import pytest

from harness import readers, stages, trace
from mvae_tpu_torch.utils.profiling import SPANS

import run


class Ev:
    def __init__(self, name, start, end, corr=0, linked=0, device=False,
                 annotation=False):
        self.name, self.start, self.end = name, start, end
        self.corr, self.linked = corr, linked
        self.device, self.annotation = device, annotation


def capture_events(program_spans):
    """A window of one step: a convolution in the ELBO's encode, a port
    kernel in a forward-alone decode call, an add in the backward (on
    autograd's thread, the main thread in the backward's span), then the
    benchmark's own readback after the step."""
    events = [
        Ev(trace.WARM_UP, 0, 100),
        Ev("cudaLaunchKernel", 10, 11, corr=1),
        Ev("warm_kernel", 20, 21, corr=1, linked=1, device=True),
        Ev(trace.WINDOW, 200, 1200),
        Ev("aten::convolution", 210, 260, corr=2),
        Ev("cudaLaunchKernel", 220, 221, corr=3),
        Ev("sm90_xmma_fprop_implicit_gemm_bf16", 300, 400, corr=3, linked=2,
           device=True),
        Ev("bench.port#0", 500, 600, corr=4),
        Ev("cudaLaunchKernel", 550, 551, corr=5),
        Ev("bn_normalize_kernel<bf16>", 600, 650, corr=5, linked=4,
           device=True),
        Ev("aten::add", 700, 900, corr=6),
        Ev("cudaLaunchKernel", 710, 711, corr=7),
        Ev("elementwise_kernel", 950, 1000, corr=7, linked=6, device=True),
        Ev("Optimizer.step#Adam.step", 300, 1000, device=True,
           annotation=True),
        Ev("cudaLaunchKernel", 1100, 1101, corr=8),     # its record lost
    ]
    if program_spans:
        events += [
            Ev("mvae.train.step", 205, 1050, corr=20),
            Ev("mvae.engine.elbo", 206, 690, corr=21),
            Ev("mvae.engine.encode", 207, 270, corr=22),
            Ev("mvae.engine.decode.stats", 450, 680, corr=23),
            Ev("mvae.train.backward", 690, 1040, corr=24),
            # the span copied onto the device's timeline
            Ev("mvae.engine.elbo", 300, 650, device=True, annotation=True),
        ]
    return events


def traced(program_spans, units=2):
    out = trace.reduce_events(capture_events(program_spans), "bench.port#")
    return dict(out, units=units, calls=[{
        "name": "bn_normalize",
        "args": (((1, 2, 3, 4), 2, "torch.bfloat16"),), "out": None}])


def gaps(t):
    busy = trace.busy_intervals(t["records"], t["window"])
    return dict(trace.idle_gaps(busy, t["window"], t["host"]))


def test_existing_readers_read_as_without_spans():
    """The records, launches, window and every existing reader are those
    of the same capture without the program's spans."""
    plain, spanned = traced(False), traced(True)
    for key in ("records", "launched", "lost", "window"):
        assert spanned[key] == plain[key], key
    for keep in (readers.is_library, readers.is_eager, readers.is_port):
        assert readers.ms_per_unit(spanned, keep) == readers.ms_per_unit(
            plain, keep)
    for read in (readers.launches_per_unit, readers.idle_share,
                 readers.port_roofline):
        assert read(spanned) == read(plain)


def test_idle_gaps_inside_a_span_take_its_name():
    """Gap middles: 250 in the convolution, 500 in the forward-alone
    decode's span outside every aten op (no host op without the spans),
    800 in the add, 1100 after the step (no host op on both)."""
    plain, spanned = gaps(traced(False)), gaps(traced(True))
    assert plain == {"aten::convolution": 100 / 1e9, "aten::add": 300 / 1e9,
                     "no host op": pytest.approx(400 / 1e9, abs=1e-15)}
    assert spanned == {"aten::convolution": 100 / 1e9,
                       "aten::add": 300 / 1e9,
                       "mvae.engine.decode.stats": 200 / 1e9,
                       "no host op": 200 / 1e9}


def test_engine_host_ms_reader():
    """engine_host_ms_per_step.train: the host span of the ELBO over the
    steps, in ms; nothing to read untraced or from a program without the
    spans."""
    read = run.metric_reader("engine_host_ms_per_step.train")
    assert read(traced(True), None) == (690 - 206) / 1e6 / 2
    assert stages.host_ms_per_unit(traced(True, units=1),
                                   "mvae.train.backward") == 350 / 1e6
    assert read(traced(False), None) is None
    assert read(None, None) is None
    assert stages.host_ms_per_unit(traced(True), "mvae.score.batch") is None


@pytest.mark.parametrize("name", SPANS)
def test_program_span_names_pass_the_filters(name):
    """Each span the port opens is kept among the host's events, and a
    kernel linked to it reads as an eager kernel, not a library one."""
    events = [Ev(trace.WINDOW, 0, 100), Ev(name, 10, 90, corr=2),
              Ev("cudaLaunchKernel", 20, 21, corr=3),
              Ev("some_kernel", 30, 40, corr=3, linked=2, device=True)]
    out = trace.reduce_events(events, "bench.port#")
    assert [e.name for e in out["host"]] == [name]
    (rec,) = out["records"]
    assert rec["op"] == name and not rec["library"] and rec["port"] is None
