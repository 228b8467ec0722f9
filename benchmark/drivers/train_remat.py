"""Driver of training traffic under gradient checkpointing
(``training.remat: true``): ``train_corpus``'s run, output check, control
and planted faults, with the traced run's attention spans taken where a
checkpointed backward allows.

``torch.utils.checkpoint(use_reentrant=False)`` lets each tensor an
autograd function saved inside a checkpointed layer be unpacked once.
``train_corpus`` reads the attention backwards' shapes from
``ctx.saved_tensors`` in a wrapper around the autograd ``backward``, which
then reads them again, and the traced run of a remat cell stops there
with ``CheckpointError``. Here the shapes are taken from the arguments of
the launchers the backward calls, which have the unpacked tensors:

- ``bench.attn_bwd``: ``flash_attention.launch_backward`` (every attention
  backward on the card);
- ``bench.attn_wide_bwd``: ``flash_attention._launch_wide``, the passes of
  ``attention_wide.cu`` (head widths above 512: the Conformer at 1280
  hidden and 2 heads).

The rest of the traced run's spans are ``train_corpus``'s. Besides its
device time under ``bench.attn_bwd``, the run reads the device time under
``bench.attn_wide_bwd`` and under the program's ``wfl.recompute`` (a
program without that span reads none). What is swapped in
``train_corpus`` for the run is put back when it ends.
"""

from __future__ import annotations

from benchmark.drivers import train_corpus
# calibrate.py calls a driver's control and faults by name
from benchmark.drivers.train_corpus import check, control, faults  # noqa: F401

# the spans whose device time the traced run reads besides train_corpus's
DEVICE_UNDER = ("bench.attn_wide_bwd", "wfl.recompute")


def run(ctx: dict) -> dict:
    traces = []
    real_install, real_trace = train_corpus._install_spans, train_corpus.Trace

    def trace(prof, *args, **kwargs):
        t = real_trace(prof, *args, **kwargs)
        traces.append(t)
        return t

    train_corpus._install_spans, train_corpus.Trace = _install_spans, trace
    try:
        out = train_corpus.run(ctx)
    finally:
        train_corpus._install_spans = real_install
        train_corpus.Trace = real_trace
    if traces:
        out["device_under"].update(
            (name, traces[0].device_s_under(name)) for name in DEVICE_UNDER)
    return out


def _launch_info(q, k, v, bias, gate, kv_len, *args, **kwargs):
    return (tuple(q.shape), q.dtype, bias is not None, kv_len)


def _wide_info(q, k, v, bias, gate, dout, lse, delta, kv, *args, **kwargs):
    return (tuple(q.shape), q.dtype, bias is not None, kv)


def _install_spans(spans) -> None:
    spans.wrap_iter("wfl_asr_tpu_torch.data.dataset:BatchLoader"
                    ".epoch_batches", "bench.loader_next")
    spans.wrap("wfl_asr_tpu_torch.train.loop:apply_update",
               "bench.optimizer")
    spans.wrap("wfl_asr_tpu_torch.train.loop:decode_bio_tags",
               "bench.host_metric")
    spans.wrap("wfl_asr_tpu_torch.ops.kernels.flash_attention:"
               "launch_backward", "bench.attn_bwd", _launch_info)
    spans.wrap("wfl_asr_tpu_torch.ops.kernels.flash_attention:_launch_wide",
               "bench.attn_wide_bwd", _wide_info)
