"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

The kernels are compiled for Hopper (`sm_90a`) by `nvcc` into one shared
library with a plain C interface, loaded with `ctypes`. The build happens
at first use, from the sources in the checkout only, into
`build/mvae_tpu_torch/` at the repository root; the library's name carries
a hash of the sources and flags, so an edited source rebuilds. Each source
compiles in its own `nvcc` process, all started together, and one link
joins them.

Dispatch rule of every op in `ops/`: a tensor on the CPU goes to the op's
plain PyTorch version, a CUDA tensor to the kernel, which either launches
or raises. There is no fallback. `plain_versions()` is the one explicit
exception: inside it, CUDA tensors go to the plain versions too, so that a
caller can hold a whole path against its plain form on the card.

Each wrapper counts its launches on its own attribute (`launched`, under
a lock: the HTTP front calls the ops from several threads at once), and
the first `library()` call of the process builds and loads the library
under a lock too.

Each kernel's wrapper and its plain version are one op of a step to
tools/measure.py:count_step_bytes (`one_op`): while it counts, a call
reports its tensor inputs and outputs, and the ops inside it (the plain
version's steps, the wrapper's allocations) go uncounted, so a kernel
counts alike on the card and on the CPU.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mvae_tpu_torch"
SOURCES = ("poe.cu", "bce_rowsum.cu", "bn_swish.cu", "conv_moments.cu",
           "status.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SM_COUNT = 132      # SMs of an H100 SXM, which the launch geometries fill
MAX_CLUSTER = 8     # blocks of one thread block cluster (csrc/reduce.cuh)

_force_plain = False
_one_op_counter = None      # set by counting()
_LAUNCH_LOCK = threading.Lock()
_LIBRARY_LOCK = threading.Lock()


@contextlib.contextmanager
def plain_versions():
    """Send CUDA tensors to the plain PyTorch versions inside the block."""
    global _force_plain
    old, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = old


@contextlib.contextmanager
def counting(counter):
    """Report every one_op call inside the block to `counter`
    (tools/measure.py:count_step_bytes)."""
    global _one_op_counter
    old, _one_op_counter = _one_op_counter, counter
    try:
        yield
    finally:
        _one_op_counter = old


def one_op(name: str):
    """Mark a kernel's wrapper or its plain version as the one op `name`
    (the module docstring); without a counter the call is the function's
    own."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            counter = _one_op_counter
            if counter is None:
                return fn(*args, **kwargs)
            with counter.one_op(name, args) as done:
                return done(fn(*args, **kwargs))
        return call
    return wrap


def use_kernel(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version); raises for a mix or any other device."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        return not _force_plain
    raise ValueError(f"tensors on devices {sorted(types)}: the ops take "
                     "all-CPU or all-CUDA inputs")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"build failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{log}")
    return logs


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists;
    returns its path. The build log lands beside it."""
    so = BUILD_DIR / f"libmvae_kernels-{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", o]
                         for s, o in zip(SOURCES, objs)])
        part = os.path.join(tmp, so.name)
        logs += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", *objs, "-o",
                           part]])
        os.replace(part, so)
    so.with_suffix(".log").write_text("\n".join(logs))
    return so


def library():
    """The loaded kernel library, built on first use. `build_seconds` is
    the wall time of the first call, the build included."""
    with _LIBRARY_LOCK:
        return _library()


@functools.cache
def _library():
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(build()))
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.mvae_poe_fwd.argtypes = [p] * 5 + [i, i, ll, i, p]
    lib.mvae_poe_bwd.argtypes = [p] * 7 + [i, i, ll, i, p]
    lib.mvae_bce_rowsum_fwd.argtypes = [p, i, p, i, i, p, i, i, i, p, p]
    lib.mvae_bce_rowsum_fwd.restype = i
    lib.mvae_bn_moments.argtypes = [p, i, p, p, i, i, i, i, p, p, p, p]
    lib.mvae_bn_normalize.argtypes = [p, i, p, p, p, p, f, p, p] + [i] * 4 + [
        p, p, p]
    lib.mvae_bn_bwd_partials.argtypes = [p, p, i, p, p, p, p] + [i] * 4 + [
        p, p, p, p]
    lib.mvae_bn_dx.argtypes = [p, p, i, p, p, p, p, p, p, f, p, p, p] + [
        i] * 4 + [p, p, p]
    lib.mvae_conv_moments.argtypes = [p, p, i, p, p] + [i] * 20 + [p]
    for fn in (lib.mvae_poe_fwd, lib.mvae_poe_bwd, lib.mvae_bn_moments,
               lib.mvae_bn_normalize, lib.mvae_bn_bwd_partials,
               lib.mvae_bn_dx, lib.mvae_conv_moments):
        fn.restype = i
    lib.mvae_error_string.argtypes = [i]
    lib.mvae_error_string.restype = ctypes.c_char_p
    lib.build_seconds = time.perf_counter() - t0
    return lib


def launched(wrapper):
    """Count one launch of a kernel on its wrapper's `launches`."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def check(name: str, code: int):
    """Raise if a launch entry point returned a CUDA error."""
    if code != 0:
        msg = library().mvae_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")


def pow2_at_least(v: int, cap: int) -> int:
    """The least power of 2 at or above v, at most cap."""
    t = 1
    while t < cap and t < v:
        t *= 2
    return t


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(cond: bool, name: str, what: str):
    if not cond:
        raise ValueError(f"{name}: {what}")
