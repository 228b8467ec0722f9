"""Share of the roofline of WavLM's fused feature-encoder convolutions
(``fused_conv_chain``, layers 1-6 in serving) in the traced window: each
chain's products and bytes (``core/counts.conv_chain``) over the device
time of its launches."""

from benchmark.core import counts
from benchmark.metrics._common import dtype_key, elem, roofline


def _bound(info):
    (b, t, c), dtype, kernels = info
    f, n = counts.conv_chain(b, t, c, kernels, elem(dtype))
    return counts.bound_s(f, n, dtype_key(dtype))[0]


def read(run):
    return roofline(run, "bench.conv_fe", _bound)
