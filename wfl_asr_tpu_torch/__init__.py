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
- ``checkpoint`` — ``.pt`` (and a JAX run's ``.pt.npz``) load/save,
                 rotation, training-state sidecars (the port's ``.train.pt``;
                 a JAX run's Prodigy ``.train.npz`` is read)
- ``infer``    — ``InferenceSession`` (``serving_quantization: int8``
                 too), ``infer_audio``, ``infer_folder_batched``, the CLI,
                 and ``infer.sampling`` (top-k / top-p, dead in the
                 pipeline as in the reference)
- ``train``    — losses, Prodigy, LR schedulers, the train loop (with
                 ``training.remat: true | auto``) and CLI
- ``correct_label`` — the label-boundary corrector and its CLI

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
