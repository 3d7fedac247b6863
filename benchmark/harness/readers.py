"""What the per-layer metric readers (metrics/<name>.py) share: sums of the
traced window's device records a unit (a train step or a scoring batch)."""

from harness import port_calls


def ms_per_unit(traced, keep):
    """Device ms a unit of the records keep(record) selects; None where
    the run was not traced or no record is selected."""
    if not traced:
        return None
    picked = [r["us"] for r in traced["records"] if keep(r)]
    if not picked:
        return None
    return sum(picked) / 1e3 / traced["units"]


def is_port(r):
    return r["port"] is not None


def is_library(r):
    return r["library"]


def is_eager(r):
    return r["port"] is None and not r["library"]


def launches_per_unit(traced):
    if not traced or not traced["launched"]:
        return None
    return traced["launched"] / traced["units"]


def port_roofline(traced):
    """The port kernels' launches' least time over their device time, in
    %: None where the run was not traced or launched no port kernel;
    raises where a launch of one lies outside the benchmark's spans
    (port_calls.py), which would leave its least time uncounted."""
    if not traced:
        return None
    records = [r for r in traced["records"] if r["port"] is not None]
    if not records:
        return None
    outside = [r["name"] for r in records if r["call"] is None]
    if outside:
        raise RuntimeError(
            f"{len(outside)} of {len(records)} launches of the port's "
            f"kernels outside the benchmark's spans, such as {outside[0]}")
    calls = {r["call"] for r in records}
    least = sum(port_calls.least_seconds(traced["calls"][i]) for i in calls)
    device = sum(r["us"] for r in records) / 1e6
    return 100.0 * least / device


def idle_share(traced):
    if not traced:
        return None
    from harness.trace import busy_intervals
    lo, hi = traced["window"]
    busy = sum(b - a for a, b in busy_intervals(traced["records"],
                                                traced["window"]))
    return 100.0 * (1.0 - busy / (hi - lo))


def mfu(window):
    """The needed operations of the untraced window over its time, as a
    share (%) of the peak for the configuration's dtype."""
    if not window or not window["flops"]:
        return None
    return 100.0 * window["flops"] / window["seconds"] / window["peak"]
