"""Device ms a batch of the kernels launched by aten convolution and
matrix-product ops (cuDNN, cuBLAS), linked by the launch's correlation id."""

from harness.readers import is_library, ms_per_unit


def read(traced, window):
    return ms_per_unit(traced, is_library)
