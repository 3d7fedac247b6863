"""Host ms a step inside the port's multi-term ELBO (its mvae.engine.elbo
span: encode, fuse, decode calls, losses and the BN commit), traced, so
the profiler's cost per op counts in it."""

from harness.stages import host_ms_per_unit


def read(traced, window):
    return host_ms_per_unit(traced, "mvae.engine.elbo")
