"""The comparisons that decide `correct`, each number beside its limit.

Training (the check that set-up drives the object of the window through:
a call of one step, then calls of the window's K steps, the last of them
the checked call; cell_train.py): each step's loss, the norm of each
leaf's first gradient as the optimizer got it, and the norm of each
leaf's change over the checked call, against the plain reference through
the same steps from the same weights, rows, terms and noise:

    loss_gap     max over the steps of |loss - ref| / |ref|
    grad_gap     max over the parameters of | |g| - |g_ref| | /
                 max(|g_ref|, the median parameter's |g_ref|)
    change_gap   the same for the change over the checked call, over the
                 parameters whose reference gradient is at least
                 GRAD_FLOOR of the median parameter's (the others move
                 under Adam by round-off alone), and the BatchNorm
                 running statistics

Scoring (a sample of the window's batches): each row's estimate against
the reference's on the same rows and draws,

    score_gap    max over the rows of |est - ref| / |ref|

A limit file (limits/<workload>.json) gives each number's limit and the
readings it was set from; a run is correct when every number is finite
and at most its limit.
"""

import json
import math
from pathlib import Path

GRAD_FLOOR = 1e-3


def leaf_norms(tensors):
    """name -> float64 norm of each tensor."""
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def norm_gap(prog, ref, names):
    """max over names of | |prog| - |ref| | / max(|ref|, median |ref|); a
    leaf the program has no reading of (an optimizer that never stepped)
    reads 0."""
    vals = sorted(ref[k] for k in names)
    med = vals[len(vals) // 2]
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def train_numbers(prog, ref):
    """prog, ref: {"losses": [...], "grad": name -> norm, "change": name
    -> norm, "stats": name -> norm}."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    params = sorted(ref["grad"])
    grad = norm_gap(prog["grad"], ref["grad"], params)
    med = sorted(ref["grad"][k] for k in params)[len(params) // 2]
    moved = [k for k in params if ref["grad"][k] >= GRAD_FLOOR * med]
    change = dict(ref["change"])
    change_prog = dict(prog["change"])
    change.update(ref["stats"])
    change_prog.update(prog["stats"])
    return {"loss_gap": loss, "grad_gap": grad,
            "change_gap": norm_gap(change_prog, change,
                                   moved + sorted(ref["stats"]))}


def score_numbers(prog, ref):
    """prog, ref: (N,) estimates of the sampled rows."""
    prog, ref = prog.double(), ref.double()
    gap = ((prog - ref).abs() / ref.abs().clamp(min=1e-30)).max()
    return {"score_gap": float(gap)}


def load_limits(root: Path, workload: str):
    path = root / "limits" / f"{workload}.json"
    with open(path) as f:
        return json.load(f)["limits"]


def verdict(numbers, limits):
    """(correct, [[name, value, limit], ...]) in the limits' order."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        rows.append([name, value, limit])
    return ok, rows

