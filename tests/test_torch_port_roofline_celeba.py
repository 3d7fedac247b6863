"""tools/roofline_celeba.py (the CelebA window by kernel category with the
step's FLOP and byte bound, the counterpart of scripts/roofline_celeba.py)
and what it adds to tools/measure.py, on the CPU:

  - measure.family_of on the kernel names the H100's CelebA bf16 window
    launched (cuDNN's forward, dgrad, wgrad and layout kernels, cuBLAS's
    gemms), with and without the aten op the profiler links each launch
    to: cuDNN's forward kernels, whose names hold "implicit_gemm", are
    conv, not gemm; and the complex GEMM cuDNN runs for a float32
    transposed convolution, conv by its op alone;
  - the profiler's raw events linked to their ops (profile_records) on
    stand-in events;
  - the Chrome trace's analysis on a fixture trace of known kernels,
    durations, ops and steps: exact numbers; the kernel records a trace
    or a capture lost (launches through the runtime or the driver with no
    kernel), the tool refusing a trace and a capture being made again
    where more than LOST_MAX were lost (measure.kept_capture); the
    capture's warm-up (utils/profiling.py) left out of both readers;
  - measure.count_step_bytes: bytes_floor's parameter, gradient, Adam and
    statistics parts equal sums over the model's parameters and
    state_dict by hand, the counts are equal on two calls, bf16 saves
    fewer activation bytes than f32, and bytes_ops counts a port kernel
    by its wrapper's inputs and outputs whether its plain version runs
    or a kernel the counter cannot see;
  - the tool's main: the capture through the CelebA train CLI (the JAX
    script's arguments, cut in width and rows here), its JSON line, and
    no device metric on the CPU.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from mvae_tpu_torch.experiments.celeba import train as celeba_cli
from mvae_tpu_torch.models import CelebaMVAE
from mvae_tpu_torch.ops import _cuda, bn, elbo, poe
from mvae_tpu_torch.tools import measure, roofline_celeba
from mvae_tpu_torch.utils.profiling import WARM_UP

ROOT = Path(__file__).resolve().parents[1]
MASKS = [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]
LAMBDAS = [[1.0, 10.0]] * 3
B = 4
CONV, GEMM = measure.CONV, measure.GEMM

# (kernel, the aten op the profiler linked its launch to, family): names
# from the CelebA bf16 window on an NVIDIA H100 80GB HBM3
# (tools/roofline_celeba.py's trace of the train CLI)
SEEN = [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize64x64x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__"
     "5x_cudnn", "aten::cudnn_convolution", CONV),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x32_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel"
     "__5x_cudnn", "aten::convolution_backward", CONV),
    ("void convolve_common_engine_float_NHWC<__nv_bfloat16, __nv_bfloat16, "
     "128, 5, 5, 3, 3, 3, true, false, false, false, false>(int, int, int)",
     "aten::cudnn_convolution", CONV),
    ("void implicit_convolve_sgemm<__nv_bfloat16, __nv_bfloat16, 1024, 5, 5,"
     " 3, 3, 3, 1, false, false, true>(int, int, int)",
     "aten::convolution_backward", CONV),
    ("sm90_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_"
     "nhwc_tilesize256x64x64_warpgroupsize1x1x1_g1_strided_execute_kernel__"
     "5x_cudnn", "aten::cudnn_convolution_transpose", CONV),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_"
     "nhwc_tilesize64x64x64_warpgroupsize1x1x1_g1_execute_segment_k_on_"
     "kernel__5x_cudnn", "aten::convolution_backward", CONV),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, "
     "__nv_bfloat16, float, false, true, (cudnnKernelDataType_t)0>()",
     "aten::cudnn_convolution_transpose", measure.LAYOUT),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, "
     "__nv_bfloat16, float, true, false, (cudnnKernelDataType_t)0>()",
     "aten::convolution_backward", measure.LAYOUT),
    ("void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, "
     "(cudnnKernelDataType_t)0>(int, int, int, int)",
     "aten::convolution_backward", CONV),
    ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvolution"
     "INS1_11threadblock22ImplicitGemmMultistage",
     "aten::convolution_backward", CONV),
    ("void cask_plugin__5x_cudnn::xmma__5x_cudnn::init_device_workspace_"
     "kernel<xmma__5x_cudnn::implicit_gemm::wgrad_indexed::Warp_specialized_"
     "params>", "aten::convolution_backward", CONV),
    ("nvjet_tst_64x56_64x14_4x2_h_bz_splitK_TNT", "aten::mm", GEMM),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, "
     "float, __nv_bfloat16, false>()", "aten::mm", GEMM),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_warpsize"
     "1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas", "aten::mm", GEMM),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_nn_align1>("
     "cutlass_80_simt_sgemm_64x64_8x5_nn_align1::Params)", "aten::mm", GEMM),
    ("void (anonymous namespace)::bn_reduce_kernel<(anonymous namespace)::"
     "MomentsOp, __nv_bfloat16, 8, false>()", "_BNSwishTrain", "bn_moments"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::"
     "native::(anonymous namespace)::TensorListMetadata<2> >()",
     "aten::_foreach_lerp_", "adam (foreach)"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float> >()",
     "aten::sum", "reduce"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "bfloat16_copy_kernel_cuda>()", "aten::copy_", "elementwise / copy"),
    # a float32 convolution with TF32 off (chip_smoke.py phase 6l)
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize"
     "256x64x8_stage3_warpsize2x2x1_g1_ffma_aligna4",
     "aten::cudnn_convolution", CONV),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_nhwc_"
     "tilesize32x32x8_stage3_warpsize1x2x1_g1_ffma",
     "aten::convolution_backward", CONV),
]
# kernels the op puts in another family than the name: cuBLAS's complex
# GEMM that cuDNN runs for the float32 transposed convolutions of the
# CelebA and celeba19 IWAE batches (26.7 ms of their 82-91 ms on the H100)
MOVED = [
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize64x64x8_stage3_"
     "warpsize2x2x1_ffma_aligna8_alignc8_execute_kernel__5x_cublas",
     "aten::cudnn_convolution_transpose", CONV, GEMM),
    ("Memset (Device)", "aten::cudnn_convolution_transpose", CONV, "other"),
]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kernel,op,family", SEEN,
                         ids=[f"{i}-{f}" for i, (_, _, f) in enumerate(SEEN)])
def test_families_of_the_kernels_seen_on_the_card(kernel, op, family):
    """Each kernel's family by the op that launched it, and by its name
    alone where the profiler links it to no op."""
    assert measure.family_of(kernel, op) == family
    assert measure.family_of(kernel) == family


@pytest.mark.parametrize("kernel,op,family,by_name", MOVED,
                         ids=["cf32-gemm", "memset"])
def test_the_op_moves_what_the_name_cannot(kernel, op, family, by_name):
    assert measure.family_of(kernel, op) == family
    assert measure.family_of(kernel) == by_name


def test_an_op_decides_a_library_kernel_and_not_the_port_kernels():
    """A conv op's kernel is conv whatever its name (cuDNN's GEMM-based
    algorithms name theirs sgemm); a gemm op's gemm; the port's kernels
    keep their names whatever op they run under; an unknown op leaves
    the name to decide."""
    sgemm = "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn>()"
    assert measure.family_of(sgemm) == GEMM
    assert measure.family_of(sgemm, "aten::convolution_backward") == CONV
    assert measure.family_of("void at::native::elementwise_kernel<>()",
                             "aten::addmm") == GEMM
    assert measure.family_of("void bn_dx_kernel<float, 4, false>()",
                             "aten::cudnn_convolution") == "bn_dx"
    assert measure.family_of("sm90_xmma_fprop_implicit_gemm_bf16",
                             "autograd::engine::evaluate_function") == CONV


def _x(cat, name, ts, dur, ext=None, **args):
    if ext is not None:
        args["External id"] = ext
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 1, "args": args}


FPROP = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
MOMENTS = "void bn_reduce_kernel<MomentsOp, __nv_bfloat16, 8, false>()"
ADD = "void at::native::vectorized_elementwise_kernel<4, add>()"


@pytest.fixture
def fixture_trace(tmp_path):
    """Two steps: a forward conv (40 us) and its memset (1 us), a gemm
    (10 us), bn_moments (6 us) under the BN's Function, and an add
    (4 us) that no op is linked to; four kernel launches and a memset;
    the profiler's own span (excluded from the wall) from 0 to 10 ms."""
    events = [
        _x("Trace", "PyTorch Profiler (0)", 0.0, 10000.0),
        _x("cpu_op", "aten::cudnn_convolution", 10.0, 20.0, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 12.0, 5.0, 1, correlation=101),
        _x("cuda_runtime", "cudaMemsetAsync", 18.0, 2.0, 1, correlation=102),
        _x("kernel", FPROP, 30.0, 40.0, 1, correlation=101),
        _x("gpu_memset", "Memset (Device)", 29.0, 1.0, 1, correlation=102),
        _x("user_annotation", "Optimizer.step#Adam.step", 100.0, 50.0, 9),
        _x("cpu_op", "aten::mm", 200.0, 20.0, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 205.0, 5.0, 2, correlation=103),
        _x("kernel", "nvjet_tst_64x8_64x16_4x2_h_bz_NNT", 230.0, 10.0, 2,
           correlation=103),
        _x("cpu_op", "_BNSwishTrain", 300.0, 30.0, 3),
        _x("cuda_runtime", "cudaLaunchKernelExC", 305.0, 5.0, 3,
           correlation=104),
        _x("kernel", MOMENTS, 320.0, 6.0, 3, correlation=104),
        _x("cuda_runtime", "cudaLaunchKernel", 400.0, 5.0, correlation=105),
        _x("kernel", ADD, 410.0, 4.0, correlation=105),
        _x("user_annotation", "Optimizer.step#Adam.step", 600.0, 40.0, 10),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 12.0, "id": 101},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_trace_analysis_on_a_fixture(fixture_trace):
    """The window's numbers from the fixture, exactly: 61 us of device time
    over 2 steps, 4 launches, the wall from the first op (10 us) to the
    last annotation's end (640 us), each category's us, share and
    launches a step, 4 of 5 device events linked to an op; a kernel for
    each launch, so no record lost."""
    records, launches, launched, wall, steps = measure.trace_records(
        fixture_trace)
    assert (launches, launched, wall, steps) == (4, 4, 630.0, 2)
    assert sorted(records) == sorted([
        (FPROP, "aten::cudnn_convolution", 40.0),
        ("Memset (Device)", "aten::cudnn_convolution", 1.0),
        ("nvjet_tst_64x8_64x16_4x2_h_bz_NNT", "aten::mm", 10.0),
        (MOMENTS, "_BNSwishTrain", 6.0), (ADD, None, 4.0)])
    got = roofline_celeba.analyze(fixture_trace, k=20)
    assert got["records_lost"] == 0
    assert got["steps"] == 2
    assert got["device_ms_per_step"] == pytest.approx(0.0305, abs=1e-12)
    assert got["window_device_ms"] == pytest.approx(0.061, abs=1e-12)
    assert got["wall_ms_per_step"] == pytest.approx(0.315, abs=1e-12)
    assert got["launches_per_step"] == 2.0
    assert got["kernels_linked_to_an_op"] == pytest.approx(0.8)
    cats = {c["family"]: c for c in got["categories"]}
    assert [c["family"] for c in got["categories"]] == [
        CONV, GEMM, "bn_moments", "elementwise / copy"]
    for fam, us, n in ((CONV, 20.5, 1.0), (GEMM, 5.0, 0.5),
                       ("bn_moments", 3.0, 0.5),
                       ("elementwise / copy", 2.0, 0.5)):
        assert cats[fam]["us_per_step"] == pytest.approx(us, abs=1e-9)
        assert cats[fam]["share"] == pytest.approx(us / 30.5)
        assert cats[fam]["launches_per_step"] == n


class _Event:
    """A raw profiler event as profile_records reads it."""

    def __init__(self, name, device, corr, linked=0, us=0.0, note=False,
                 start_us=0.0):
        self._v = dict(name=name, device_type=device, correlation_id=corr,
                       linked_correlation_id=linked,
                       duration_ns=int(us * 1e3), is_user_annotation=note,
                       start_ns=int(start_us * 1e3))

    def __getattr__(self, key):
        return lambda: self._v[key]


def test_profile_records_link_each_kernel_to_its_op():
    """Each device event takes the op its linked correlation id names
    (the aten op where another host event shares that id, as the
    profiler's activity-buffer event does); the runtime's launches are
    counted; a device annotation and an unlinked kernel as the profiler
    gives them."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _Event("Activity Buffer Request", cpu, 11),
        _Event("aten::cudnn_convolution", cpu, 11),
        _Event("_BNSwishTrain", cpu, 12),
        _Event("cudaLaunchKernel", cpu, 101, linked=11),
        _Event("cudaLaunchKernelExC", cpu, 102, linked=12),
        _Event("cudaMemsetAsync", cpu, 103, linked=11),
        _Event("cuLaunchKernel", cpu, 106, linked=12),
        _Event(FPROP, cuda, 101, linked=11, us=40.0),
        _Event(MOMENTS, cuda, 102, linked=12, us=6.0),
        _Event("Memset (Device)", cuda, 103, linked=11, us=1.0),
        _Event(ADD, cuda, 104, linked=99, us=4.0),
        _Event("Optimizer.step#Adam.step", cuda, 105, us=50.0, note=True)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    records, launches, launched = measure.profile_records(Prof)
    assert (launches, launched) == (2, 3)
    assert records == [(FPROP, "aten::cudnn_convolution", 40.0),
                       (MOMENTS, "_BNSwishTrain", 6.0),
                       ("Memset (Device)", "aten::cudnn_convolution", 1.0),
                       (ADD, None, 4.0)]
    groups, _, _ = measure.breakdown(records, 1)
    assert groups == pytest.approx({CONV: 0.041, "bn_moments": 0.006,
                                    "elementwise / copy": 0.004})


def _warm_up(cpu, cuda, kernel=True):
    """A capture's warm-up (utils/profiling.py) as raw events, from 0 to
    60 us: its span, its op, a launch, and the launch's kernel where
    `kernel`."""
    events = [_Event(WARM_UP, cpu, 1, us=60.0, note=True),
              _Event("aten::fill_", cpu, 2, us=10.0, start_us=5.0),
              _Event("cudaLaunchKernel", cpu, 90, linked=2, us=4.0,
                     start_us=8.0)]
    if kernel:
        events.append(_Event(ADD, cuda, 90, linked=2, us=2.0, start_us=20.0))
    return events


@pytest.mark.parametrize("kernel", [True, False],
                         ids=["its-kernel-kept", "its-kernel-lost"])
def test_profile_records_leave_the_warm_up_out(kernel):
    """The warm-up's launch and its kernel's record are no part of the
    capture, and a warm-up whose record the profiler dropped leaves the
    capture with no record lost."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = _warm_up(cpu, cuda, kernel) + [
        _Event("aten::mm", cpu, 3, start_us=100.0),
        _Event("cudaLaunchKernel", cpu, 91, linked=3, start_us=102.0),
        _Event("nvjet_tst_64x8", cuda, 91, linked=3, us=10.0,
               start_us=110.0)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    records, launches, launched = measure.profile_records(Prof)
    assert records == [("nvjet_tst_64x8", "aten::mm", 10.0)]
    assert (launches, launched) == (1, 1)
    assert measure.records_lost(records, launched) == 0


@pytest.mark.parametrize("kernel", [True, False],
                         ids=["its-kernel-kept", "its-kernel-lost"])
def test_trace_records_leave_the_warm_up_out(fixture_trace, kernel):
    """A warm-up before the fixture's window (its span, op, launch, sync
    and kernel) changes none of the window's numbers."""
    want = measure.trace_records(fixture_trace)
    events = [_x("user_annotation", WARM_UP, -50000.0, 300.0),
              _x("cpu_op", "aten::fill_", -49990.0, 20.0, 7),
              _x("cuda_runtime", "cudaLaunchKernel", -49980.0, 5.0, 7,
                 correlation=90),
              _x("cuda_runtime", "cudaDeviceSynchronize", -49960.0, 50.0)]
    if kernel:
        events.append(_x("kernel", ADD, -49970.0, 2.0, 7, correlation=90))
    got = measure.trace_records(_trace_with(fixture_trace, events))
    assert sorted(got[0]) == sorted(want[0]) and got[1:] == want[1:]
    assert roofline_celeba.analyze(fixture_trace, k=20)["records_lost"] == 0


def test_host_ops_leave_the_warm_up_out():
    """The host's op table (profile_breakdown's host_top) counts the
    window's ops and none of the warm-up's."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WARM_UP):
            x = torch.zeros(1)
            for _ in range(9):
                x.add_(1)
        y = torch.ones(3)
        y.add_(2)
        y.mul_(3)
    ops = measure.host_ops(prof)
    assert WARM_UP not in ops and "aten::zeros" not in ops
    assert (ops["aten::add_"][1], ops["aten::mul_"][1]) == (1, 1)


def _trace_with(path, events, drop=None):
    """The fixture trace at path, less the events named drop, plus
    events."""
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e["name"] != drop] + events
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def _launches(n, ts=500.0):
    """n launches through the driver with no kernel."""
    return [_x("cuda_driver", "cuLaunchKernel", ts + i, 0.5, 4)
            for i in range(n)]


@pytest.mark.parametrize("drop, events, lost", [
    (ADD, [], 1),
    (None, _launches(1), 1),
    (None, _launches(1) + [_x("kernel", "sm90_xmma_dgrad_bf16", 520.0, 8.0,
                              4)], 0),
    (None, _launches(measure.LOST_MAX + 1), measure.LOST_MAX + 1)],
    ids=["a-kernel-lost", "a-driver-launch-without-its-kernel",
         "a-driver-launch-and-its-kernel", "more-than-LOST_MAX"])
def test_the_records_a_trace_lost(fixture_trace, drop, events, lost):
    """Each launch through the runtime or the driver needs its kernel's
    record; a memset has none to need."""
    path = _trace_with(fixture_trace, events, drop)
    assert roofline_celeba.analyze(path, k=20)["records_lost"] == lost


def test_main_refuses_a_trace_that_lost_too_many_records(fixture_trace):
    path = _trace_with(fixture_trace, _launches(measure.LOST_MAX + 1))
    with pytest.raises(SystemExit, match="kernel records; run --capture"):
        roofline_celeba.main(["--trace-dir", str(Path(path).parent),
                              "--device", "cpu"])


@pytest.mark.parametrize("retaken", [0, 1, measure.CAPTURES - 1,
                                     measure.CAPTURES])
def test_a_capture_that_lost_too_many_records_is_made_again(retaken,
                                                            capsys):
    """A capture that lost more than LOST_MAX kernel records (launches
    without a kernel; memsets are not kernels) is made again, up to
    CAPTURES in all, and one that lost LOST_MAX is kept with its count;
    none kept raises."""
    made = []
    memset = ("Memset (Device)", None, 1.0)

    def capture():
        made.append(len(made))
        if len(made) <= retaken:
            return made[-1], [memset], measure.LOST_MAX + 1
        return (made[-1], [memset, (ADD, None, 4.0), (FPROP, "conv", 40.0)],
                measure.LOST_MAX + 2)

    if retaken == measure.CAPTURES:
        with pytest.raises(RuntimeError, match="kernel records"):
            measure.kept_capture("stand-in", capture)
    else:
        result, records, lost = measure.kept_capture("stand-in", capture)
        assert (result, len(records), lost) == (retaken, 3,
                                                measure.LOST_MAX)
    assert len(made) == min(retaken + 1, measure.CAPTURES)
    assert capsys.readouterr().out.count("kernel records") == retaken


def _celeba(dtype=None, b=B, seed=0):
    model = CelebaMVAE(8, dtype, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    data = {"image": torch.from_numpy((rng.random((2 * b, 64, 64, 3)) * 255)
                                      .astype(np.uint8)),
            "attrs": torch.from_numpy((rng.random((2 * b, 18)) < 0.3)
                                      .astype(np.float32))}
    return model, data


@pytest.fixture(scope="module")
def counts():
    """count_step_bytes of CelebaMVAE(8), f32 and bf16, at B = 4, twice."""
    torch.set_num_threads(1)
    out = {}
    for dtype in (None, torch.bfloat16):
        model, data = _celeba(dtype)
        out[dtype] = (model, data, [measure.count_step_bytes(
            model, MASKS, LAMBDAS, data, B) for _ in range(2)])
    return out


def test_bytes_floor_parts_are_sums_by_hand(counts):
    """The parameters read twice and written once, their gradients written
    and read, Adam's two moments read and written, the running statistics
    read and written, and the batch's rows as they lie resident."""
    model, data, (got, _) = counts[None]
    sd = model.state_dict()
    p = sum(v.numel() * v.element_size() for _, v in model.named_parameters())
    stats = sum(v.numel() * v.element_size() for k, v in sd.items()
                if k.endswith(("running_mean", "running_var")))
    assert p == sum(sd[k].numel() * 4 for k, _ in model.named_parameters())
    assert got.parts["params"] == 3 * p
    assert got.parts["grads"] == 2 * p
    assert got.parts["adam"] == 4 * p
    assert got.parts["bn_stats"] == 2 * stats
    assert got.parts["batch"] == B * (64 * 64 * 3 + 18 * 4)
    assert got.parts["saved"] > 0 and got.saved_weights > 0
    assert got.floor == sum(got.parts.values())
    assert got.ops > got.floor and got.n_ops > 0


def test_counts_are_equal_on_two_calls(counts):
    for dtype, (_, _, (a, b)) in counts.items():
        assert a == b, dtype


def test_bf16_saves_fewer_activation_bytes_than_f32(counts):
    f32, bf16 = counts[None][2][0], counts[torch.bfloat16][2][0]
    assert bf16.parts["saved"] < f32.parts["saved"]
    assert bf16.parts["params"] == f32.parts["params"]


def _unseen(fn):
    """fn run where the byte counter does not see its ops, as a kernel's
    launch on the card."""
    def run(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return run


def _kernels(monkeypatch, marked):
    """Route the CPU tensors to stand-ins for the kernels: each runs the
    plain version unseen, marked one op as the wrappers are (or not)."""
    def stand_in(name, plain):
        fn = _unseen(plain.__wrapped__)
        return _cuda.one_op(name)(fn) if marked else fn

    monkeypatch.setattr(_cuda, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(poe, "poe_fwd", stand_in("poe_fwd", poe.poe_plain))
    monkeypatch.setattr(poe, "poe_bwd",
                        stand_in("poe_bwd", poe.poe_bwd_plain))
    monkeypatch.setattr(elbo, "bce_rowsum_fwd",
                        stand_in("bce_rowsum_fwd", elbo.bce_rowsum_plain))
    monkeypatch.setitem(bn._PASSES, True, tuple(
        stand_in(name, plain) for name, plain in zip(
            ("bn_moments", "bn_normalize", "bn_bwd_partials", "bn_dx"),
            bn._PASSES[False])))


def test_bytes_ops_count_a_kernel_by_its_wrapper(counts, monkeypatch):
    """The step counted with kernels the counter cannot see (the card's)
    equals the step counted with the plain versions (the CPU's); without
    the one-op mark the kernels' reads and writes would be missing."""
    model, data, (plain, _) = counts[None]
    with monkeypatch.context() as m:
        _kernels(m, marked=True)
        assert measure.count_step_bytes(model, MASKS, LAMBDAS, data,
                                        B) == plain
    with monkeypatch.context() as m:
        _kernels(m, marked=False)
        unmarked = measure.count_step_bytes(model, MASKS, LAMBDAS, data, B)
    assert unmarked.ops < plain.ops and unmarked.floor == plain.floor


def test_one_op_counts_its_arguments_and_results():
    x4 = torch.randn(2, 3, 4, 5)
    counter = measure._ByteCounter([])
    with _cuda.counting(counter), counter:
        s, q = bn.bn_moments_plain(x4)
    assert counter.ops == 1
    assert counter.bytes == 4 * (x4.numel() + s.numel() + q.numel())


def test_step_bound_takes_the_larger():
    got = measure.step_bound(int(989e9), int(3.35e9), 989e12)
    assert got["compute_ms"] == pytest.approx(1.0)
    assert got["memory_ms"] == pytest.approx(1.0)
    more = measure.step_bound(10, int(6.7e9), 989e12)
    assert more["bound_by"] == "bytes"
    assert more["bound_ms"] == pytest.approx(2.0)


def test_capture_argv_is_the_jax_scripts():
    """scripts/roofline_celeba.py:33-43 runs one epoch at B = 100,
    annealing 1, L = 100 and windows of 20 steps."""
    src = (ROOT / "scripts" / "roofline_celeba.py").read_text()
    pairs = re.findall(r'"(--[a-z-]+)", "(\d+)"', src)
    assert [a for pair in pairs for a in pair] == roofline_celeba.CAPTURE_ARGV
    cli = celeba_cli.parser().parse_args(roofline_celeba.CAPTURE_ARGV)
    assert (cli.n_latents, cli.batch_size, cli.bf16, cli.conv_moments) == (
        100, 100, True, False)


@pytest.fixture
def small(monkeypatch):
    """The capture at a CPU's size: L = 8, B = 20 on 200 synthetic rows,
    windows of 2 steps."""
    monkeypatch.setattr(roofline_celeba, "CAPTURE_ARGV", [
        "--epochs", "1", "--batch-size", "20", "--annealing-epochs", "1",
        "--n-latents", "8", "--log-interval", "2"])
    load = celeba_cli.load_celeba
    monkeypatch.setattr(celeba_cli, "load_celeba", lambda d, part, **kw: load(
        d, part, synthetic_n=200 if part == "train" else 40, **kw))


def test_main_captures_and_reads_the_trace(small, monkeypatch, capsys,
                                           tmp_path):
    """Without a card the tool raises unless --device cpu. --capture runs
    the CLI with --profile-dir (trace.json there; the window's 2 Adam
    steps), the line is what main returns, holds the counts of the CLI's
    step from shapes and no device metric; reading the trace again
    without --capture gives the same line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(measure, "smi_line", lambda: 1 / 0)
    argv = ["--trace-dir", str(tmp_path / "t")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        roofline_celeba.main(argv + ["--capture"])
    out = roofline_celeba.main(argv + ["--capture", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines == [out]
    assert (tmp_path / "t" / "trace.json").is_file() and out["steps"] == 2
    assert out["device"] == "cpu" and out["config"].startswith(
        "CelebaMVAE(8) bf16, B=20, T=3")
    for key in ("device_ms_per_step", "idle_share", "launches_per_step",
                "categories", "bound_share_of_device",
                "bound_share_of_wall"):
        assert out[key] is None, key
    model = CelebaMVAE(8, torch.bfloat16, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    flops = measure.count_step(model, MASKS, LAMBDAS, 20)
    assert (out["flops_per_step"], out["dead_flops_per_step"]) == (
        flops.needed, flops.dead)
    assert out["bytes_floor"] == sum(out["bytes_floor_parts"].values())
    assert out["bound_ms"] == max(out["compute_ms"], out["memory_ms"])
    assert out["bound_by"] == "bytes"
    again = roofline_celeba.main(argv + ["--device", "cpu"])
    assert again == out
