"""Share of the wide attention backward's roofline in the traced training
updates: the five-product bound of each call of the passes of
``attention_wide.cu`` (head widths above 512; the Conformer at 1280 hidden
and 2 heads), over the device time of what those calls launched
(``bench.attn_wide_bwd``), in %."""

from benchmark.metrics._common import attention_bwd_bound, roofline


def read(run):
    return roofline(run, "bench.attn_wide_bwd", attention_bwd_bound)
