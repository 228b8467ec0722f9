"""Model FLOPs utilization of training: three forwards (a forward and a
backward of twice its work) of every item of every update in the window,
at the item's true length (its label frames for the heads), plus
Prodigy's arithmetic, over the window's seconds times the float32 peak
(``core/peaks.json``)."""

from benchmark.core import counts


def read(run):
    cfg, flops = run["cfg"], 0.0
    for items in run["window_updates"]:
        for samples, frames in items:
            flops += 3 * counts.forward_flops(cfg, samples,
                                              run["num_labels"], frames)
        flops += counts.optimizer_flops(run["num_params"])
    return 100.0 * flops / (run["window_s"]
                            * counts.peak_flops("f32_tf32x3"))
