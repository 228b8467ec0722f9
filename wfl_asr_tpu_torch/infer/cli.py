"""Inference CLI — the flags of ``wfl_asr_tpu/infer/cli.py`` (the
reference's click interface, infer.py:359-454), with ``--device``
defaulting to ``cuda``. ``--device cpu`` runs on the CPU; with no CUDA
device and no ``--device cpu`` the run raises. With ``WFL_PROFILE_DIR``
set, the run records a ``torch.profiler`` trace into
``$WFL_PROFILE_DIR/infer/trace.json`` (``utils.profiling.maybe_trace``),
with the program's ``wfl.*`` spans as ranges.

    python -m wfl_asr_tpu_torch.infer PATH -ckpt best_model.pt -c config.yaml
"""

from __future__ import annotations

import sys
from pathlib import Path

import click


@click.command(help="Infer with WFL")
@click.argument("path", metavar="PATH")
@click.option("--checkpoint", "-ckpt", type=str, required=True,
              help="Path to WFL Checkpoint.")
@click.option("--config", "-c", type=str, required=True,
              help="Path to Config file.")
@click.option("--output", "-o", type=str, required=False, default=".",
              help="Path to output labels.")
@click.option("--lang-id", "-l", type=int, required=False, default=None,
              help="Language ID.")
@click.option("--sample", "-s", is_flag=True,
              help="Enable sampling instead of argmax")
@click.option("--top-k", "-tk", type=int, default=0,
              help="Top-K sampling (range: 1-20)")
@click.option("--top-p", "-tp", type=float, default=0.0,
              help="Top-P sampling (range: 0.1-1)")
@click.option("--temperature", "-temp", type=float, default=1.0,
              help="Sampling temperature (range: 0.1-2)")
@click.option("--device", "-d", type=str, default="cuda",
              help='Device to use: "cuda" (default) or "cpu".')
@click.option("--confidence-threshold", "-ct", type=float, default=None,
              help="Suppress predictions with low confidence. Set 0 to disable.")
@click.option("--batch-size", "-b", type=int, default=1,
              help="Folder mode: batch this many files per forward "
                   "(throughput mode; identical outputs).")
def main(path, checkpoint, config, output, lang_id, sample, top_k, top_p,
         temperature, device, confidence_threshold, batch_size):
    # Flag validation mirrors reference infer.py:377-391.
    if sample:
        if top_k <= 0 and top_p <= 0.0:
            print("Sampling is enabled but neither --top-k nor --top-p is set.")
            sys.exit(1)
        if top_k > 0 and top_p > 0.0:
            print("You can't use both --top-k and --top-p at the same time.")
            sys.exit(1)
        if top_k < 0:
            print("top-k must be ≥ 1.")
            sys.exit(1)
        if top_p < 0.0 or top_p > 1.0:
            print("top-p must be between 0.1 and 1.0.")
            sys.exit(1)
        if temperature <= 0.0:
            print("temperature must be greater than 0.")
            sys.exit(1)

    from ..config import load_raw_config
    inf_path = Path(path)
    raw_cfg = load_raw_config(config)
    if confidence_threshold is None:
        confidence_threshold = raw_cfg.get("postprocess", {}) \
            .get("confidence_threshold", 0.0)
    if output == ".":
        # default single-file output is the sibling .lab (the reference
        # would overwrite the .wav itself, infer.py:410-411)
        output_path = (inf_path if inf_path.is_dir()
                       else inf_path.with_suffix(".lab"))
    else:
        output_path = output
    if not inf_path.exists():
        print(f"Unable to locate folder {inf_path}")
        sys.exit(1)
    if lang_id is not None and lang_id <= -1:
        lang_id = None

    from ..utils.profiling import maybe_trace
    from .pipeline import infer_audio, infer_folder, infer_folder_batched
    with maybe_trace("infer"):
        if inf_path.is_dir():
            if batch_size > 1:
                infer_folder_batched(
                    folder_path=str(inf_path), config_path=str(config),
                    checkpoint_path=str(checkpoint),
                    output_dir=str(output_path), lang_id=lang_id,
                    confidence_threshold=confidence_threshold,
                    batch_files=batch_size, device=device)
            else:
                infer_folder(
                    folder_path=str(inf_path), config_path=str(config),
                    checkpoint_path=str(checkpoint),
                    output_dir=str(output_path), device=device,
                    lang_id=lang_id, sample=sample, top_k=top_k,
                    top_p=top_p, temperature=temperature,
                    confidence_threshold=confidence_threshold)
        else:
            segments = infer_audio(
                audio_path=str(inf_path), config_path=str(config),
                checkpoint_path=str(checkpoint),
                output_lab_path=str(output_path), device=device,
                lang_id=lang_id, sample=sample, top_k=top_k, top_p=top_p,
                temperature=temperature,
                confidence_threshold=confidence_threshold)
            print("Predicted segments:")
            for start, end, ph in segments:
                print(f"({round(start, 2)}, {round(end, 2)}, {ph})")
    import torch.distributed as dist
    if dist.is_initialized():        # joined under torchrun
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
