"""Dataset preprocessing: walk ``data_dir/<lang>/*.wav`` (+ ``.lab``) and emit
the reference-compatible artifact set into ``save_dir``:

- ``dataset.json``             (wav_path, bio_tags, phoneme_segments, lang_id)
- ``lang_phonemes.json``       per-language phoneme inventories
- ``phoneme_merge_map.json``   reverse merge map (only when non-empty)
- ``phonemes.txt``             sorted union of B-/I- tags + "O"
- ``langs.txt``                ``lang,id`` lines
- ``config.yaml``              re-written with ``num_languages``

Behavioral contract: reference preprocess.py:69-195, including the
incremental-id extension of existing ``langs.txt``/``phonemes.txt`` (finetune
friendly) and ``num_frames = int(duration / frame_duration)``. The port of
``wfl_asr_tpu/preprocess.py``: the same artifacts, byte for byte.

    python -m wfl_asr_tpu_torch.preprocess CONFIG
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict

from .config import Config, save_raw_config
from .data.audio import wav_duration
from .labels import build_merge_map, parse_lab, to_bio_tags


def preprocess(data_dir: str, config: Dict[str, Any]) -> None:
    cfg = Config(config)
    frame_duration = cfg.frame_duration
    save_dir = cfg.save_dir

    lang_dirs = sorted(d for d in os.listdir(data_dir)
                       if os.path.isdir(os.path.join(data_dir, d)))
    merge_map, reverse_map = build_merge_map(cfg.merged_phoneme_groups)

    # Incremental extension of existing language / phoneme inventories
    # (reference preprocess.py:74-101).
    lang2id: Dict[str, int] = {}
    existing_phonemes = set()
    langs_txt_path = os.path.join(save_dir, "langs.txt")
    phonemes_txt_path = os.path.join(save_dir, "phonemes.txt")

    if os.path.exists(langs_txt_path):
        with open(langs_txt_path, "r", encoding="utf-8") as f:
            for line in f:
                fields = line.strip().split(",")
                if len(fields) == 2:
                    lang2id[fields[0]] = int(fields[1])

    if os.path.exists(phonemes_txt_path):
        with open(phonemes_txt_path, "r", encoding="utf-8") as f:
            for line in f:
                tag = line.strip()
                if tag and tag != "O" and (tag.startswith("B-") or tag.startswith("I-")):
                    existing_phonemes.add(tag[2:])

    next_id = max(lang2id.values(), default=-1) + 1
    for lang in lang_dirs:
        if lang not in lang2id:
            lang2id[lang] = next_id
            next_id += 1

    dataset = []
    phoneme_set = set()
    lang_phonemes: Dict[str, set] = {}

    for lang in lang_dirs:
        lang_path = os.path.join(data_dir, lang)
        wav_files = sorted(glob.glob(os.path.join(lang_path, "*.wav")))
        lang_phonemes[lang] = set()

        print(f"[{lang}] {len(wav_files)} wav files")
        for wav_path in wav_files:
            base = os.path.splitext(os.path.basename(wav_path))[0]
            lab_path = os.path.join(lang_path, base + ".lab")
            if not os.path.exists(lab_path):
                print(f"Missing label for {base}, skipping.")
                continue

            # Only the duration is needed here — read the header, not the
            # samples (the reference decodes the whole file; same result).
            n_samples, sr = wav_duration(wav_path)
            num_frames = int((n_samples / sr) / frame_duration)

            segments = []
            for start, end, ph in parse_lab(lab_path):
                merged_ph = merge_map.get(lang, {}).get(ph, ph)
                segments.append((start, end, merged_ph))
                phoneme_set.add(merged_ph)
                lang_phonemes[lang].add(merged_ph)

            dataset.append({
                "wav_path": wav_path,
                "bio_tags": to_bio_tags(segments, num_frames, frame_duration),
                "phoneme_segments": segments,
                "lang_id": lang2id[lang],
            })

    os.makedirs(save_dir, exist_ok=True)

    with open(os.path.join(save_dir, "dataset.json"), "w") as f:
        json.dump(dataset, f, indent=2)

    with open(os.path.join(save_dir, "lang_phonemes.json"), "w", encoding="utf-8") as f:
        json.dump({k: sorted(v) for k, v in lang_phonemes.items()},
                  f, indent=2, ensure_ascii=False)

    merge_map_path = os.path.join(save_dir, "phoneme_merge_map.json")
    if reverse_map:
        with open(merge_map_path, "w", encoding="utf-8") as f:
            json.dump(reverse_map, f, indent=2, ensure_ascii=False)

    all_phonemes = existing_phonemes | phoneme_set
    all_tags = ({f"B-{ph}" for ph in all_phonemes}
                | {f"I-{ph}" for ph in all_phonemes}
                | {"O"})
    with open(phonemes_txt_path, "w", encoding="utf-8") as f:
        for tag in sorted(all_tags):
            f.write(f"{tag}\n")

    with open(langs_txt_path, "w", encoding="utf-8") as f:
        for lang, idx in lang2id.items():
            f.write(f"{lang},{idx}\n")

    if merge_map:
        print("\nApplied merged phoneme groups:")
        for lang, mapping in merge_map.items():
            for src, tgt in mapping.items():
                print(f"  {lang}/{src} -> {tgt}")

    print(f"\nProcessed {len(dataset)} samples.")
    print(f"\nGenerated {len(all_tags)} BIO labels -> {phonemes_txt_path}")
    print(f"\nSaved language mapping -> {langs_txt_path}")
    # Console parity with reference preprocess.py:182-189: the phoneme-list
    # / merge-map save lines and the per-language usage dump.
    print(f"\nSaved language phoneme list -> "
          f"{os.path.join(save_dir, 'lang_phonemes.json')}")
    if reverse_map:
        print(f"\nSaved phoneme merge map -> {merge_map_path}")
    print("\nPhoneme usage by language:")
    for lang, phonemes in lang_phonemes.items():
        print(f"  {lang}: {sorted(list(phonemes))}")

    cfg.num_languages = len(lang2id)
    save_raw_config(config, os.path.join(save_dir, "config.yaml"))
    print(f"\nSaved updated config -> {os.path.join(save_dir, 'config.yaml')}")


def main() -> None:
    import argparse
    from .config import load_raw_config
    parser = argparse.ArgumentParser(description="Preprocess a WFL dataset")
    parser.add_argument("config", nargs="?", default="config.yaml",
                        help="Path to config.yaml")
    args = parser.parse_args()
    config = load_raw_config(args.config)
    preprocess(config["data"]["data_dir"], config)


if __name__ == "__main__":
    main()
