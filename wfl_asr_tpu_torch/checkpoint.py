"""Model checkpoints with the reference's ``.pt`` contract, and the
training state beside them — the port of ``wfl_asr_tpu/checkpoint.py``.

A ``.pt`` is a torch state_dict under the reference ``BIOPhonemeTagger``'s
keys — what ``wfl_asr_tpu.checkpoint.save_model_checkpoint`` writes and
what usamireko/WFL-ASR's ``train.py`` saves — so checkpoints move between
the three unchanged. A ``model_step{N}.pt.npz`` (what a torch-less JAX run
writes: ``save_pytree_npz`` of the same flattened dict) loads where there
is no ``.pt``. The orbax format is not read (it needs ``orbax``, which
imports jax).

The training state the reference never persists (optimizer state, step,
dropout generator, LR scheduler) goes into a sidecar
``model_step{N}.train.pt`` in the port's own format (a ``torch.save``d
dict). Where there is none, a JAX run's ``model_step{N}.train.npz`` is read
instead: its Prodigy state (the moments, ``s`` and ``p0`` mapped onto the
port's parameters through ``export_tagger``; d, d_max, the numerator, the
step) and its scheduler scalars. A JAX sidecar of another optimizer, and
the JAX PRNG key, cannot map onto the port: such a run starts its
optimizer fresh (Prodigy anchors to the loaded parameters at its first
step) and its generator from the seed, as a checkpoint without a sidecar
does.

Rotation, best and last follow reference train.py:276-290, 420-433, 453;
every file is written atomically (temporary file, fsync, rename).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.convert import export_tagger
from .models.tagger import BIOPhonemeTagger, TaggerArch
from .train.prodigy import Prodigy


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
    """The state_dict in a ``.pt``, or else in ``path + ".npz"`` (the JAX
    package's ``.pt.npz``: the same keys, "/"-joined where nested); raises
    on a missing or torn file."""
    if os.path.exists(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    if os.path.exists(path + ".npz"):
        with np.load(path + ".npz", allow_pickle=False) as data:
            return {k.replace("/", "."): torch.from_numpy(np.array(data[k]))
                    for k in data.files}
    raise FileNotFoundError(path)


def load_model_checkpoint(path: str, arch: TaggerArch,
                          device="cpu") -> BIOPhonemeTagger:
    """Build the tagger for ``arch`` and load a ``.pt`` (or ``.pt.npz``)
    into it with ``strict=True``; returns it in eval mode on ``device``."""
    model = BIOPhonemeTagger(arch)
    model.load_state_dict(read_state_dict(path), strict=True)
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# Training state sidecar, rotation and resume discovery
# ---------------------------------------------------------------------------

def train_sidecar_path(model_path: str) -> str:
    return re.sub(r"\.pt$", "", model_path) + ".train.pt"


def save_train_state(model_path: str, optimizer, step: int,
                     generator: torch.Generator,
                     scheduler_state: Optional[Dict] = None,
                     extra: Optional[Dict] = None) -> None:
    """Optimizer state (an optimizer, or its ``state_dict`` already taken),
    step, the dropout generator's state and the LR scheduler's state beside
    ``model_path``; ``extra``: more entries (a sharded run's per-rank
    generator states)."""
    opt_state = optimizer if isinstance(optimizer, dict) \
        else optimizer.state_dict()
    _atomic_save({"optimizer": opt_state, "step": int(step),
                  "generator": generator.get_state(),
                  "scheduler": dict(scheduler_state or {}),
                  **dict(extra or {})},
                 train_sidecar_path(model_path))


def load_train_state(model_path: str) -> Optional[dict]:
    """The sidecar's dict (keys optimizer, step, generator, scheduler), or
    None when there is none."""
    path = train_sidecar_path(model_path)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


# ---------------------------------------------------------------------------
# The JAX package's sidecar (``save_train_state``: opt:: leaves by keypath)
# ---------------------------------------------------------------------------

def jax_sidecar_path(model_path: str) -> str:
    return re.sub(r"\.pt$", "", model_path) + ".train.npz"


# Prodigy's state under optax.inject_hyperparams (``.inner_state``), chained
# with the freeze mask when the encoder is frozen (``.inner_state[0]``)
_JAX_PRODIGY = re.compile(
    r"opt::\.inner_state(?:\[0\])?\."
    r"(step|d|d_max|d_numerator|exp_avg|exp_avg_sq|s|p0)((?:\[[^\]]+\])*)")
_PER_PARAM = ("exp_avg", "exp_avg_sq", "s", "p0")


def _nest(leaves: Dict[str, np.ndarray]):
    """{"['a'][0]['w']": x, ...} (jax keypath suffixes) → the nested pytree
    of dicts and lists they flatten."""
    root: Dict = {}
    for path, val in leaves.items():
        keys = [int(k) if k.isdigit() else k.strip("'\"")
                for k in re.findall(r"\[([^\]]+)\]", path)]
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [listify(node[i]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}
    return listify(root)


def _export_state_tree(tree, encoder_type: str) -> Dict[str, np.ndarray]:
    """A param-shaped JAX tree (a Prodigy moment) under the reference's
    state_dict keys, with torch layouts (``export_tagger``; the Conformer's
    BatchNorm statistics, which no optimizer holds, exported as zeros)."""
    bn = {"bn": {"mean": np.zeros(1), "var": np.zeros(1)}}
    state = {"conformer": [bn] * len(tree.get("conformer", []))}
    return export_tagger(tree, state, encoder_type)


def _state_dict_key(name: str) -> str:
    """A parameter's name → its state_dict key (WavLM's pos conv weight is
    stored in the reference's weight-norm form, its v the weight)."""
    if name.endswith("pos_conv_embed.conv.weight"):
        return name[:-len("weight")] + "parametrizations.weight.original1"
    return name


def restore_jax_train_state(model_path: str, model: BIOPhonemeTagger,
                            optimizer: torch.optim.Optimizer
                            ) -> Optional[dict]:
    """Read the JAX package's ``.train.npz`` beside ``model_path`` into
    ``optimizer`` (a port :class:`Prodigy` over ``model``'s parameters);
    returns {"step", "scheduler"} when it did, None when there is no such
    sidecar or it cannot map onto the port (another optimizer's state, or
    a port optimizer that is not Prodigy) — logged, and the optimizer left
    fresh. The JAX PRNG key is never mapped."""
    path = jax_sidecar_path(model_path)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as data:
        stored = {k: np.asarray(data[k]) for k in data.files}
    parts: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in stored.items():
        m = _JAX_PRODIGY.fullmatch(key)
        if m:
            parts.setdefault(m.group(1), {})[m.group(2)] = val
    name = os.path.basename(path)
    if not isinstance(optimizer, Prodigy) or not all(
            k in parts for k in ("d", "d_max", "d_numerator", "step")
            + _PER_PARAM):
        print(f"[INFO] {name}: a JAX optimizer state that does not map onto "
              f"the port's {type(optimizer).__name__} (only Prodigy's "
              f"does); the optimizer starts fresh")
        return None
    exported = {k: _export_state_tree(_nest(parts[k]),
                                      model.arch.encoder_type)
                for k in _PER_PARAM}
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    optimizer.state.clear()
    for p in params:
        key = _state_dict_key(names[id(p)])
        optimizer.state[p] = {
            k: torch.from_numpy(np.array(exported[k][key], np.float32))
            .reshape(p.shape).to(p.device) for k in _PER_PARAM}
    f32 = dict(dtype=torch.float32, device=params[0].device)
    optimizer.state[params[0]].update(
        {k: torch.tensor(float(parts[k][""]), **f32)
         for k in ("d", "d_max", "d_numerator")},
        k=torch.tensor(float(parts["step"][""]), **f32))
    print(f"[INFO] {name}: restored the JAX run's Prodigy state (step "
          f"{int(stored['step'])}); its PRNG key does not map onto the "
          f"port's generator, which continues from the seed")
    return {"step": int(stored["step"]),
            "scheduler": {k.removeprefix("sched::"): float(v)
                          for k, v in stored.items()
                          if k.startswith("sched::")}}


def find_resume_checkpoints(save_dir: str) -> List[Tuple[str, int]]:
    """Every ``model_step{N}.pt`` (or ``.pt.npz``) in save_dir as (the
    ``.pt`` path, step), newest first, so resume can fall back past a
    checkpoint a crash left torn."""
    found = {}
    for name in os.listdir(save_dir):
        m = re.fullmatch(r"model_step(\d+)\.pt(\.npz)?", name)
        if m:
            found[int(m.group(1))] = name.removesuffix(".npz")
    return [(os.path.join(save_dir, name), step)
            for step, name in sorted(found.items(), reverse=True)]


def remove_checkpoint(model_path: str) -> None:
    """Delete a checkpoint (``.pt`` or ``.pt.npz``) and its training
    sidecar (the port's, or a JAX ``.train.npz``)."""
    for victim in (model_path, model_path + ".npz",
                   train_sidecar_path(model_path),
                   jax_sidecar_path(model_path)):
        if os.path.exists(victim):
            os.remove(victim)
