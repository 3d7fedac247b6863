"""What the readers of the program's own spans share.

The port opens torch.profiler spans at the stages of its train step and
its IWAE scorer (mvae_tpu_torch/utils/profiling.py: SPANS, each named
"mvae.<layer>.<stage>"), and only while a capture is running. A traced
run's `host` (trace.py:reduce_events) keeps them beside the aten ops, so
a reader finds them there by name. A program without them (an earlier
commit) leaves every reader here with nothing to read: it returns None.
"""


def host_ms_per_unit(traced, name):
    """Host ms a unit (a step or a batch) inside the spans named `name`,
    each span from its start to its end, the profiler's own cost in it;
    None where the run was not traced or has no such span."""
    spans = [e.end - e.start for e in traced["host"]
             if e.name == name] if traced else []
    if not spans:
        return None
    return sum(spans) / 1e6 / traced["units"]
