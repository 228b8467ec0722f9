"""The plain reference of the benchmark's configurations, in float32.

Plain ``torch`` and NumPy, written from the published descriptions (the
WavLM and Whisper papers and their ``config.json`` files, the tagger's
heads as WFL-ASR defines them, the Prodigy paper's algorithm). It imports
nothing of the program under test, nor JAX. It runs in float32 with
TF32 off (:func:`strict_f32`), and serves as the yardstick that decides whether a
run's outputs are ``correct``.

- ``frontend``: wav2vec2 normalization, Whisper's log-mel;
- ``encoders``: the WavLM (post-LN, gated relative position bias) and
  Whisper encoders;
- ``tagger``: the heads (language conditioning, BiLSTM, Conformer,
  dilated convs, classifier, boundary-offset head) over an encoder, the
  state-dict names a WFL-ASR checkpoint has, and the weight spec the
  benchmark draws its seeded weights from;
- ``losses``, ``prodigy``: the training objective and the optimizer;
- ``postprocess``: confidence gate, median filter, BIO decode, segment
  merging, HTK ``.lab`` text;
- ``data``: a training corpus worked out from its wav and ``.lab`` files
  (labels, split, batch order, augmentation, collation).
"""

import contextlib

import torch


@contextlib.contextmanager
def tf32(matmul: bool, cudnn: bool):
    """TF32 in cuBLAS's products (``matmul``) and in cuDNN's convolutions
    and RNNs (``cudnn``) inside, as given; the flags are put back after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def strict_f32():
    """Float32 products everywhere inside: no TF32 in cuBLAS or cuDNN."""
    return tf32(False, False)


@contextlib.contextmanager
def lowered(precision: str):
    """A control's precision inside; yields the dtype to compute in.
    "bf16": bfloat16, the step below the configurations' float32 with TF32
    products allowed (the control); "tf32": float32 storage with TF32
    products in cuBLAS and cuDNN (a reading that shows why TF32 is not the
    control)."""
    if precision == "tf32":
        with tf32(True, True):
            yield torch.float32
    elif precision == "bf16":
        with strict_f32():
            yield torch.bfloat16
    else:
        raise ValueError(f"precision {precision!r}")
