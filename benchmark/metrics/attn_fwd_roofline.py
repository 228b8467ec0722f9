"""Share of the attention forwards' roofline in the traced serving window:
Σ over the calls of ``flash_attention`` and ``flash_attention_trainable``
of max(FLOPs / peak, bytes / 3.35 TB/s), over the device time of every
operation launched inside those calls (the entry points' padding and
copies with the kernels). Peaks: ``core/peaks.json`` (f32 at the
three-TF32 rate)."""

from benchmark.metrics._common import attention_fwd_bound, roofline


def read(run):
    return roofline(run, "bench.attn_fwd", attention_fwd_bound)
