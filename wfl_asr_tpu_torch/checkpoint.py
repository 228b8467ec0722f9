"""Model checkpoints with the reference's ``.pt`` contract, the port of
``wfl_asr_tpu/checkpoint.py:81-158`` (``.pt`` only).

A ``.pt`` is a torch state_dict under the reference ``BIOPhonemeTagger``'s
keys — what ``wfl_asr_tpu.checkpoint.save_model_checkpoint`` writes and
what usamireko/WFL-ASR's ``train.py`` saves — so checkpoints move between
the three unchanged. The orbax and ``.pt.npz`` formats and the training
sidecar are not ported (ROADMAP.md Queue 1, training).
"""

from __future__ import annotations

import os

import torch

from .models.tagger import BIOPhonemeTagger, TaggerArch


def save_model_checkpoint(path: str, model: BIOPhonemeTagger) -> None:
    """Write ``model.state_dict()`` (on the CPU) atomically: a temporary
    file, fsync, then rename, so a crash never leaves a torn ``.pt``."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(sd, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_model_checkpoint(path: str, arch: TaggerArch,
                          device="cpu") -> BIOPhonemeTagger:
    """Build the tagger for ``arch`` and load a ``.pt`` into it with
    ``strict=True``; returns it in eval mode on ``device``."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = BIOPhonemeTagger(arch)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()
