"""The reduction of a capture to records (harness/trace.py) on made-up
events: the warm-up left out, each kernel's op and port span, the
records lost, the busy intervals and the idle gaps by host op."""

import pytest

from harness import readers, trace


class Ev:
    def __init__(self, name, start, end, corr=0, linked=0, device=False,
                 annotation=False):
        self.name, self.start, self.end = name, start, end
        self.corr, self.linked = corr, linked
        self.device, self.annotation = device, annotation


def capture_events():
    return [
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


def test_reduce_events():
    out = trace.reduce_events(capture_events(), "bench.port#")
    names = [r["name"] for r in out["records"]]
    assert names == ["sm90_xmma_fprop_implicit_gemm_bf16",
                     "bn_normalize_kernel<bf16>", "elementwise_kernel"]
    conv, bn, ew = out["records"]
    assert conv["op"] == "aten::convolution" and conv["library"]
    assert bn["port"] == "bn_normalize" and bn["call"] == 0
    assert not bn["library"] and ew["op"] == "aten::add"
    assert not ew["library"] and ew["port"] is None
    assert out["launched"] == 4 and out["lost"] == 1
    assert out["window"] == (200, 1200)


def test_busy_idle_and_readers():
    out = trace.reduce_events(capture_events(), "bench.port#")
    busy = trace.busy_intervals(out["records"], out["window"])
    assert busy == [[300, 400], [600, 650], [950, 1000]]
    gaps = dict(trace.idle_gaps(busy, out["window"], out["host"]))
    # gap middles: 250 (convolution), 500 (none: the port span is ours),
    # 800 (add), 1100 (none)
    assert gaps["aten::convolution"] == 100 / 1e9
    assert gaps["aten::add"] == 300 / 1e9
    assert abs(gaps["no host op"] - (200 + 200) / 1e9) < 1e-15
    traced = dict(out, units=2, calls=[{
        "name": "bn_normalize",
        "args": (((1, 2, 3, 4), 2, "torch.bfloat16"),), "out": None}])
    # one 0.1 us record over 2 units, in ms
    assert readers.ms_per_unit(traced, readers.is_library) == 0.1e-3 / 2
    assert readers.launches_per_unit(traced) == 2.0
    assert abs(readers.idle_share(traced) - 100 * (1 - 200 / 1000)) < 1e-9
    roof = readers.port_roofline(traced)
    assert roof == 100 * (1 * 2 * 3 * 4 * 2 / 3.35e12) / (0.05 / 1e6)


def test_roofline_silent_without_port_kernels_and_strict_without_spans():
    out = trace.reduce_events(capture_events(), "bench.port#")
    assert readers.port_roofline(None) is None
    recs = [r for r in out["records"] if r["port"] is None]
    assert readers.port_roofline(dict(out, records=recs, units=1,
                                      calls=[])) is None
    recs = [dict(r, call=None) for r in out["records"]]
    with pytest.raises(RuntimeError, match="outside the benchmark's spans"):
        readers.port_roofline(dict(out, records=recs, units=1, calls=[]))
