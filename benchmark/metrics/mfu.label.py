"""Model FLOPs utilization of serving: the forward FLOPs of every file
labelled in the window, at its exact length and once for every language
row it ran (``core/counts.forward_flops``), over the window's length
(its start to its last ``.lab``) times the float32 peak
(``core/peaks.json``: 165 TFLOP/s, three TF32 products)."""

from benchmark.core import counts


def read(run):
    cfg, langs = run["cfg"], run["cfg"]["assumed"]["num_languages"]
    flops = sum(langs * counts.forward_flops(cfg, f[3], run["num_labels"])
                for f in run["counted_files"])
    return 100.0 * flops / (run["window_s"] * counts.peak_flops("f32_tf32x3"))
