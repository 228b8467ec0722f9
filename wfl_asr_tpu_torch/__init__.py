"""WFL-ASR in PyTorch for NVIDIA Hopper (H100): the port of ``wfl_asr_tpu``.

The package mirrors the JAX package's module names, so each module's
counterpart is easy to find. It imports ``torch`` and never ``jax`` nor
anything of ``wfl_asr_tpu``; the host-side modules it needs (config, labels,
WAV I/O, checkpoint conversion) are its own copies.

- ``config``, ``labels``, ``metrics``, ``data.audio`` — host modules
                 (copies)
- ``preprocess`` — ``data_dir`` → ``dataset.json``, ``phonemes.txt``, ...
- ``data.dataset`` — the bucketed batch loader
- ``models``   — WavLM encoder, heads and the BIO tagger as ``nn.Module``s
                 whose state_dict keys are the reference checkpoint's
- ``ops``      — the wav2vec2 normalize, the postprocess ops, and
                 ``ops.kernels``: hand-written CUDA kernels (sm_90a) for the
                 TPU kernels of the inference and training paths, each
                 beside its plain PyTorch twin
- ``checkpoint`` — ``.pt`` load/save, rotation, training-state sidecars
- ``infer``    — ``InferenceSession``, ``infer_audio``,
                 ``infer_folder_batched`` and the CLI
- ``train``    — losses, Prodigy, LR schedulers, the train loop and CLI

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
