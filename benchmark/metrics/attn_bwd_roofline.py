"""Share of the attention backwards' roofline in the traced training
window: the five-product bound of each backward of the attention autograd
functions (WavLM's biased K2b, the bias-free K1b of the Conformer and of
Whisper) over the device time of what those backwards launched."""

from benchmark.metrics._common import attention_bwd_bound, roofline


def read(run):
    return roofline(run, "bench.attn_bwd", attention_bwd_bound)
