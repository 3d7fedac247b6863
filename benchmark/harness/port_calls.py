"""Spans that the benchmark opens around the calls into the port's
kernels, and what each call's launch needs at the least (the yardstick of
the kernels' rooflines).

In a traced run, `recording()` puts a wrapper of the benchmark's own in
place of each kernel entry that KERNEL_CALLS names in the port's ops
modules, and in the tables of those modules that hold them (TABLES):
around each call it opens a profiler span named SPAN + the call's number,
and keeps the kernel's name and the shapes and dtypes of the call's
arguments and results. The port's own entries are put back after. An
entry the port no longer has raises: what the yardstick reads does not
depend on a hook that the program may drop or report through as it
chooses. The kernels' plain versions are wrapped too, so that the same
records come from a CPU run.

A launch's least time is the larger of its operations at the card's peak
for its dtype and its bytes at the memory rate, each input byte read once
and each output byte written once (kernel_cost). Elementwise arithmetic
is not counted as operations; only conv2d_moments' products are.
"""

import contextlib
import functools
import importlib

import torch

from harness.yardstick import HBM_BYTES_PER_S, PEAK_FLOPS

SPAN = "bench.port#"

# module -> {entry: the kernel it launches (or whose plain version it is)}
KERNEL_CALLS = {
    "mvae_tpu_torch.ops.bn": {
        "bn_moments": "bn_moments", "bn_moments_plain": "bn_moments",
        "bn_normalize": "bn_normalize",
        "bn_normalize_plain": "bn_normalize",
        "bn_bwd_partials": "bn_bwd_partials",
        "bn_bwd_partials_plain": "bn_bwd_partials",
        "bn_dx": "bn_dx", "bn_dx_plain": "bn_dx"},
    "mvae_tpu_torch.ops.elbo": {
        "bce_rowsum_fwd": "bce_rowsum_fwd",
        "bce_rowsum_plain": "bce_rowsum_fwd"},
    "mvae_tpu_torch.ops.poe": {
        "poe_fwd": "poe_fwd", "poe_plain": "poe_fwd",
        "poe_bwd": "poe_bwd", "poe_bwd_plain": "poe_bwd"},
    "mvae_tpu_torch.ops.convbn": {
        "conv2d_moments_fwd": "conv2d_moments",
        "conv2d_moments_plain": "conv2d_moments"},
}
# module -> its tables that hold entries themselves (ops/bn.py's passes)
TABLES = {"mvae_tpu_torch.ops.bn": ("_PASSES",)}


def _meta(x):
    """(shape, itemsize, dtype name) of a tensor, the value otherwise."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.element_size(), str(x.dtype))
    if isinstance(x, (tuple, list)):
        return type(x)(_meta(v) for v in x)
    return x


class Recorder:
    """The calls of a traced run (module docstring)."""

    def __init__(self):
        self.calls = []

    def wrap(self, kernel, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            entry = {"name": kernel,
                     "args": _meta(args + tuple(kwargs.values())),
                     "out": None}
            index = len(self.calls)
            self.calls.append(entry)
            with torch.profiler.record_function(f"{SPAN}{index}"):
                out = fn(*args, **kwargs)
            entry["out"] = _meta(out)
            return out
        return call


def _swap(table, wrapped):
    """A copy of a table (dicts, tuples, lists) with each entry that
    `wrapped` holds replaced by its wrapper."""
    if isinstance(table, dict):
        return {k: _swap(v, wrapped) for k, v in table.items()}
    if isinstance(table, (tuple, list)):
        return type(table)(_swap(v, wrapped) for v in table)
    return wrapped.get(table, table)


@contextlib.contextmanager
def recording():
    """A Recorder whose wrappers stand in the port's ops modules inside the
    block (module docstring)."""
    rec = Recorder()
    put = []            # (module, attribute, the port's own object)
    try:
        for name, entries in KERNEL_CALLS.items():
            mod = importlib.import_module(name)
            wrapped = {}
            for attr, kernel in entries.items():
                if not hasattr(mod, attr):
                    raise RuntimeError(f"the port has no {name}.{attr}: "
                                       "the benchmark cannot span its "
                                       "kernel calls")
                fn = getattr(mod, attr)
                wrapped[fn] = rec.wrap(kernel, fn)
                put.append((mod, attr, fn))
                setattr(mod, attr, wrapped[fn])
            for attr in TABLES.get(name, ()):
                if not hasattr(mod, attr):
                    raise RuntimeError(f"the port has no {name}.{attr}")
                table = getattr(mod, attr)
                put.append((mod, attr, table))
                setattr(mod, attr, _swap(table, wrapped))
        yield rec
    finally:
        for mod, attr, own in reversed(put):
            now = getattr(mod, attr)
            # a wrapper counted the launches its kernel entry counts
            if hasattr(own, "launches") and now is not own:
                own.launches = now.launches
            setattr(mod, attr, own)


def _bytes(m):
    shape, itemsize, _ = m
    n = 1
    for d in shape:
        n *= d
    return n * itemsize


def _tensors(tree):
    if isinstance(tree, tuple) and len(tree) == 3 and isinstance(
            tree[0], tuple) and isinstance(tree[1], int):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def kernel_cost(call):
    """(operations, bytes, peak FLOP/s) of one call's launch: every tensor
    argument read once, every tensor result written once; conv2d_moments'
    multiply-adds at 2 operations each."""
    ins, outs = _tensors(call["args"]), _tensors(call["out"])
    nbytes = sum(_bytes(t) for t in ins + outs)
    dtype = ins[0][2]
    flops = 0
    if call["name"] == "conv2d_moments":
        (b, cin, _, _), _, _ = ins[0]
        (cout, _, k, k2), _, _ = ins[1]
        (_, _, oh, ow), _, _ = outs[0]
        flops = 2 * b * oh * ow * cout * cin * k * k2
    peak = PEAK_FLOPS["bfloat16" if "bfloat16" in dtype else "float32"]
    return flops, nbytes, peak


def least_seconds(call):
    flops, nbytes, peak = kernel_cost(call)
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)
