"""Model checkpoints with the reference's ``.pt`` contract, and the
training state beside them — the port of ``wfl_asr_tpu/checkpoint.py``
(``.pt`` only).

A ``.pt`` is a torch state_dict under the reference ``BIOPhonemeTagger``'s
keys — what ``wfl_asr_tpu.checkpoint.save_model_checkpoint`` writes and
what usamireko/WFL-ASR's ``train.py`` saves — so checkpoints move between
the three unchanged. The orbax and ``.pt.npz`` formats are not ported.

The training state the reference never persists (optimizer state, step,
dropout generator, LR scheduler) goes into a sidecar
``model_step{N}.train.pt`` in the port's own format (a ``torch.save``d
dict). A checkpoint without one — the reference's, or the JAX package's
with its ``.train.npz`` — resumes with a fresh optimizer, which Prodigy
anchors to the loaded parameters at its first step.

Rotation, best and last follow reference train.py:276-290, 420-433, 453;
every file is written atomically (temporary file, fsync, rename).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from .models.tagger import BIOPhonemeTagger, TaggerArch


def _atomic_save(obj, path: str) -> None:
    """``torch.save`` to a temporary file, fsync, then rename, so a crash
    never leaves a torn file at ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_model_checkpoint(path: str, model: BIOPhonemeTagger) -> None:
    """Write ``model.state_dict()`` (on the CPU) atomically."""
    _atomic_save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                 path)


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict in a ``.pt`` (raises on a missing or torn file)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_checkpoint(path: str, arch: TaggerArch,
                          device="cpu") -> BIOPhonemeTagger:
    """Build the tagger for ``arch`` and load a ``.pt`` into it with
    ``strict=True``; returns it in eval mode on ``device``."""
    model = BIOPhonemeTagger(arch)
    model.load_state_dict(read_state_dict(path), strict=True)
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# Training state sidecar, rotation and resume discovery
# ---------------------------------------------------------------------------

def train_sidecar_path(model_path: str) -> str:
    return re.sub(r"\.pt$", "", model_path) + ".train.pt"


def save_train_state(model_path: str, optimizer: torch.optim.Optimizer,
                     step: int, generator: torch.Generator,
                     scheduler_state: Optional[Dict] = None) -> None:
    """Optimizer state, step, the dropout generator's state and the LR
    scheduler's state beside ``model_path``."""
    _atomic_save({"optimizer": optimizer.state_dict(), "step": int(step),
                  "generator": generator.get_state(),
                  "scheduler": dict(scheduler_state or {})},
                 train_sidecar_path(model_path))


def load_train_state(model_path: str) -> Optional[dict]:
    """The sidecar's dict (keys optimizer, step, generator, scheduler), or
    None when there is none."""
    path = train_sidecar_path(model_path)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def find_resume_checkpoints(save_dir: str) -> List[Tuple[str, int]]:
    """Every ``model_step{N}.pt`` in save_dir as (path, step), newest
    first, so resume can fall back past a checkpoint a crash left torn."""
    found = {}
    for name in os.listdir(save_dir):
        m = re.fullmatch(r"model_step(\d+)\.pt", name)
        if m:
            found[int(m.group(1))] = name
    return [(os.path.join(save_dir, name), step)
            for step, name in sorted(found.items(), reverse=True)]


def remove_checkpoint(model_path: str) -> None:
    """Delete a checkpoint and its training sidecar (the port's, or a JAX
    ``.train.npz``)."""
    stem = re.sub(r"\.pt$", "", model_path)
    for victim in (model_path, train_sidecar_path(model_path),
                   stem + ".train.npz"):
        if os.path.exists(victim):
            os.remove(victim)
