"""Time the port's reductions at launch geometries other than the ones
their wrappers pick, on the card: the readings by which ops/bn.py's
reduce_launch (REDUCE_LOADS, PLANE_THREADS, SPLIT_THREADS, COLUMNS_WIDE)
and ops/elbo.py's BCE_CHUNKS are set (PERF.md section 6). The PoE
kernels' one column a thread in blocks of 128 are constants of
csrc/poe.cu, set by this tool's readings of other forms (PERF.md section
6); it times them as the wrappers launch them.

    python -m mvae_tpu_torch.tools.geometry_probe             # candidates
    python -m mvae_tpu_torch.tools.geometry_probe --wrappers  # wrappers only

Run from the repository root (it takes chip_smoke.py's timers). The
candidates go through the C entry points, which take any geometry their
checks accept, so no rebuild is needed; each is checked against the plain
version, then timed by back_to_back_ms twice, in turns (forward, then
backward over the list). --wrappers times only what the wrappers launch,
through their public signatures, so that the same file gives the readings
of another tree of the port at the same shapes.
"""

import argparse
import ctypes
import subprocess

import torch

import chip_smoke as cs
from mvae_tpu_torch.ops import _cuda
from mvae_tpu_torch.ops import bn as bn_ops
from mvae_tpu_torch.ops import poe as poe_ops
from mvae_tpu_torch.ops.elbo import bce_rowsum_fwd, bce_rowsum_plain

# the BatchNorm1d layers of the CelebA train step (f32, S = 1): the
# attribute encoder's (x2 a step) and decoder's (x3)
S1_SHAPES = ((1, 100, 512, 1), (3, 100, 512, 1))
# its conv maps (bf16): the encoder's conv2-conv4, the decoder's
# convT1-convT3
MAP_SHAPES = ((1, 100, 64, 256), (1, 100, 128, 64), (1, 100, 256, 25),
              (3, 100, 128, 64), (3, 100, 64, 256), (3, 100, 32, 1024))
# the BCE's image rows: the f32 step's (f32 logits and targets), the eval
# step's (f32 logits, bf16 targets) and the bf16 train step's
BCE_CASES = ((300, 300, 12288, torch.float32, torch.float32),
             (300, 100, 12288, torch.float32, torch.bfloat16),
             (300, 100, 12288, torch.bfloat16, torch.bfloat16))
# the PoE's (T, M, B, D): the train and eval steps' (forward and backward),
# a serving bucket's (forward only)
POE_CASES = (((3, 2, 100, 100), ("poe_fwd", "poe_bwd")),
             ((1, 2, 64, 100), ("poe_fwd",)))


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bn_inputs(shape, dev, g, dtype=torch.float32):
    x4 = (0.5 + 1.5 * torch.randn(shape, generator=g, device=dev)).to(dtype)
    g4 = torch.randn(shape, generator=g, device=dev).to(dtype)
    a = 1.0 + 0.2 * torch.randn(shape[0], shape[2], generator=g, device=dev)
    b = 0.2 * torch.randn(shape[0], shape[2], generator=g, device=dev)
    return x4, g4, a, b


def bce_inputs(case, dev, g):
    n, nt, k, xdt, tdt = case
    x = (3 * torch.randn((n, k), generator=g, device=dev)).to(xdt)
    t = torch.rand((nt, k), generator=g, device=dev).to(tdt)
    return x, t


def bce_at(geo):
    """bce_rowsum_fwd launched at the 5-int geometry geo (csrc/
    bce_rowsum.cu: BceLaunch)."""
    lib = _cuda.library()
    arr = (ctypes.c_int * 5)(*geo)

    def fn(x, t):
        out = torch.empty((x.shape[0],), device=x.device)
        rc = lib.mvae_bce_rowsum_fwd(
            x.data_ptr(), int(x.dtype == torch.bfloat16), t.data_ptr(),
            int(t.dtype == torch.bfloat16), 0, out.data_ptr(), *x.shape,
            t.shape[0], arr, _cuda.stream(x.device))
        _cuda.check(f"bce at {geo}", rc)
        return out
    return fn


def in_turns(cands, flush):
    """{label: [two back_to_back_ms readings]}, read forward then back."""
    got = {label: [] for label, _, _ in cands}
    for label, fn, args in cands + cands[::-1]:
        got[label].append(cs.back_to_back_ms(fn, args, flush))
    return got


def show(what, got, name):
    best = sorted(got.items(), key=lambda kv: min(kv[1]))
    print(f"[probe] {what}: back_to_back_ms, two readings in turns, fastest "
          f"first: " + "; ".join(f"{k} {v}" for k, v in best)
          + f" | {name}", flush=True)


def reduction_geometries(shape):
    """(label, 6-int geometry): at S = 1 the columns mapping (w: channels a
    block), at a conv map the rows mapping (16-byte chunks where S holds
    them, the threads along a row as the wrapper sets them); each at
    threads a block x blocks that share the plane (s 1: a plain launch,
    else a cluster)."""
    n, s = shape[1], shape[3]
    for splits in (1, 2, 4, 8):
        rows = -(-n // splits)
        splits = -(-n // rows)
        if s == 1:
            for wide in (4, 8, 16, 32):
                for threads in (128, 256, 512):
                    yield (f"w{wide} t{threads} s{splits}",
                           (1, 1, splits, rows, threads, wide))
        else:
            vec = 8 if s % 8 == 0 else 1
            for threads in (256, 512):
                tpr = _cuda.pow2_at_least(s // vec, threads)
                yield (f"t{threads} s{splits}",
                       (0, vec, splits, rows, threads, tpr))


def reduction_candidates(dev, g, flush, name):
    """Both BN reductions at the train step's BN layers: the BatchNorm1d
    ones in f32, the conv maps in bf16."""
    for shape in S1_SHAPES + MAP_SHAPES:
        dtype = torch.float32 if shape[3] == 1 else torch.bfloat16
        args = bn_inputs(shape, dev, g, dtype)
        per = shape[1] * shape[3]
        for op, plain, inputs in (
                ("moments", bn_ops.bn_moments_plain, args[:1]),
                ("partials", bn_ops.bn_bwd_partials_plain, args)):
            want = torch.stack(plain(*inputs)) / per
            cands = []
            for label, geo in reduction_geometries(shape):
                fn = cs.reduction_at(op, geo)
                torch.testing.assert_close(torch.stack(fn(*inputs)) / per,
                                           want, **cs.BN_SUM_TOL)
                cands.append((label, fn, inputs))
            show(f"bn {op} {shape} {str(dtype).split('.')[-1]}",
                 in_turns(cands, flush), name)


def bce_candidates(dev, g, flush, name):
    """A wide row over one block or a cluster of 2-4, 128 or 256 threads."""
    for case in BCE_CASES:
        x, t = bce_inputs(case, dev, g)
        want = bce_rowsum_plain(x, t)
        vec = 16 // min(x.element_size(), t.element_size())
        chunks = case[2] // vec
        cands = []
        for threads in (128, 256):
            for splits in (1, 2, 3, 4):
                span = -(-chunks // splits)
                geo = (vec, threads, threads, -(-chunks // span), span)
                fn = bce_at(geo)
                torch.testing.assert_close(fn(x, t), want, **cs.BCE_TOL)
                cands.append((f"t{threads} s{geo[3]} "
                              f"({-(-span // threads)} chunks a thread)",
                              fn, (x, t)))
        show(f"bce logits ({case[0]},{case[2]}) {case[3]}, targets "
             f"({case[1]},{case[2]}) {case[4]}", in_turns(cands, flush),
             name)


def wrappers(dev, g, flush, name):
    """What the wrappers launch at the same shapes, and the PoE kernels at
    theirs (those of them that the tree has)."""
    for (t, m, b, d), kernels in POE_CASES:
        mu, lv = torch.randn((2, m, b, d), generator=g, device=dev)
        masks = torch.tensor(cs.MASKS[:t] if t == 3 else [[1.0] * m],
                             device=dev)
        grads = tuple(torch.randn((2, t, b, d), generator=g, device=dev))
        for kern in kernels:
            if not hasattr(poe_ops, kern):
                continue
            args = (mu, lv, masks) + (grads if kern == "poe_bwd" else ())
            show(f"wrapper {kern} T={t} M={m} B={b} D={d}",
                 in_turns([("wrapper", getattr(poe_ops, kern), args)],
                          flush), name)
    for shape in S1_SHAPES:
        x4, g4, a, b = bn_inputs(shape, dev, g)
        for op, fn, args in (("moments", bn_ops.bn_moments, (x4,)),
                             ("partials", bn_ops.bn_bwd_partials,
                              (x4, g4, a, b))):
            show(f"wrapper bn {op} {shape} f32",
                 in_turns([("wrapper", fn, args)], flush), name)
    for case in BCE_CASES:
        x, t = bce_inputs(case, dev, g)
        show(f"wrapper bce logits ({case[0]},{case[2]}) {case[3]}, targets "
             f"({case[1]},{case[2]}) {case[4]}",
             in_turns([("wrapper", bce_rowsum_fwd, (x, t))], flush), name)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wrappers", action="store_true",
                    help="time only what the wrappers launch")
    opts = ap.parse_args()
    dev = torch.device("cuda", 0)
    name = card()
    g = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    _cuda.library()
    wrappers(dev, g, flush, name)
    if not opts.wrappers:
        reduction_candidates(dev, g, flush, name)
        bce_candidates(dev, g, flush, name)


if __name__ == "__main__":
    main()
