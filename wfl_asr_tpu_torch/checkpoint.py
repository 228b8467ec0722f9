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


# An optimizer state leaf under optax.inject_hyperparams: the chain's index
# path (none for a bare transform; one more level, [0], when the encoder is
# frozen and the chain ends in masked(set_to_zero)), the state's field, and
# the parameter's keypath (sm3's per-axis accumulators add the axis)
_JAX_LEAF = re.compile(r"opt::\.inner_state((?:\[\d+\])*)\.(\w+)"
                       r"((?:\[[^\]]+\])*)")
# optax field → the port's state key where they differ
_PORT_KEY = {"sm3": {"mu": "accumulators"}}


class _Unmappable(ValueError):
    """A JAX optimizer state that does not map onto the port's optimizer."""


def _tree(items) -> Dict:
    """[(path tuple, value)] → the nested pytree of dicts and lists (a dict
    whose keys are all ints becomes a list)."""
    root: Dict = {}
    for keys, val in items:
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


def _nest(leaves: Dict[str, np.ndarray]):
    """{"['a'][0]['w']": x, ...} (jax keypath suffixes) → the nested pytree
    of dicts and lists they flatten."""
    return _tree(([int(k) if k.isdigit() else k.strip("'\"")
                   for k in re.findall(r"\[([^\]]+)\]", path)], val)
                 for path, val in leaves.items())


def _export_state_tree(tree, encoder_type: str) -> Dict[str, np.ndarray]:
    """A param-shaped JAX tree (an optimizer moment) under the reference's
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


def _map_tree(fn, tree, path=()):
    """``fn(path, leaf)`` over every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _leaves_of(tree, path=()):
    """[(path, leaf)] in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_of(tree[k],
                                                            path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves_of(v, path + (i,))]
    return [(path, tree)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _stacked_depth(tree) -> int:
    """L when the tree's encoder layers are stacked (a JAX PP run's state:
    ``layers`` one dict of ``[L, ...]`` leaves), else 0."""
    layers = tree.get("encoder", {}).get("layers") \
        if isinstance(tree, dict) else None
    if not isinstance(layers, dict):
        return 0
    return int(np.shape(_leaves_of(layers)[0][1])[0])


def _unstack(tree, split):
    """The tree with its stacked encoder layers as a list of per-layer
    trees; ``split(leaf)`` gives a stacked leaf's L per-layer values."""
    depth = _stacked_depth(tree)
    if not depth:
        return tree
    tree = dict(tree)
    enc = dict(tree["encoder"])
    layers = enc["layers"]
    enc["layers"] = [_map_tree(lambda _, v, i=i: split(v)[i], layers)
                     for i in range(depth)]
    tree["encoder"] = enc
    return tree


def _adafactor_shapes(v_row, v_col, v, group) -> List[tuple]:
    """The leaf shapes its adafactor moments allow: ``v``'s when unfactored,
    else every shape whose factored axes (d1, d0) leave ``v_row`` (without
    d0) and ``v_col`` (without d1) — a 2-D leaf and its transpose both
    do."""
    from .train.optimizers import _factored_dims
    r, c = tuple(np.shape(v_row)), tuple(np.shape(v_col))
    if np.shape(v) != (1,) or (r == (1,) and c == (1,)):
        return [tuple(np.shape(v))]
    n, out = len(r) + 1, []
    for d0 in range(n):
        for d1 in range(n):
            if d0 == d1:
                continue
            shape = list(r)
            shape.insert(d0, c[d0 if d0 < d1 else d0 - 1])
            shape = tuple(shape)
            if (tuple(x for i, x in enumerate(shape) if i != d1) == c
                    and _factored_dims(shape, group["factored"],
                                       group["min_dim_size_to_factor"])
                    == (d1, d0) and shape not in out):
                out.append(shape)
    return out


def _adafactor_leaf_map(trees, views, depth: int, group, encoder_type):
    """The :class:`_LeafMap` of an adafactor state without a
    parameter-shaped field: each leaf's shape the one its moments allow
    whose export has its parameter's shape (a linear's leaf is its
    transpose)."""
    from .train.optimizers import _factored_dims
    rows, cols, full = (trees[k] for k in ("v_row", "v_col", "v"))
    cands = {}
    for path, v in _leaves_of(full):
        shapes = _adafactor_shapes(_get(rows, path), _get(cols, path), v,
                                   group)
        if depth and path[:2] == ("encoder", "layers"):
            kept = []
            for shape in shapes:
                dims = _factored_dims(shape, group["factored"],
                                      group["min_dim_size_to_factor"])
                if shape[0] == depth and not (dims and 0 in dims):
                    kept.append(shape[1:])
            if not kept:
                raise _Unmappable("a stacked leaf factors its layer axis")
            shapes = kept
        cands[path] = shapes
    pick = dict.fromkeys(cands, 0)
    target = {key: tuple(p.shape) for p, key, _ in views}
    for _ in range(4):
        leaf_map = _LeafMap(_shape_tree(
            {k: c[pick[k]] for k, c in cands.items()}, depth), encoder_type)
        wrong = {leaf_map.leaves[int(i)][0]
                 for key, arr in leaf_map.ids.items()
                 if key in target and np.shape(arr) != target[key]
                 for i in np.unique(arr)}
        if not wrong:
            return leaf_map
        for path in wrong:
            base = _stacked_path(path, depth)[0] if depth else path
            pick[base] = (pick[base] + 1) % len(cands[base])
    raise _Unmappable("no leaf shapes fit the port's parameters")


class _LeafMap:
    """Where each port parameter's leaf views sit in the JAX tree: for the
    parameter's ``i``-th view (``leaf_blocks`` rows, else the whole), the
    JAX leaf's path and shape and, for each axis of the view, the JAX axis
    it runs along (None for a size-1 axis the JAX leaf does not have). Found
    by exporting a tree of leaf ids and one of flat indices, so every
    layout change ``export_tagger`` makes (transposes, concatenations,
    reshapes) is followed."""

    def __init__(self, shapes, encoder_type: str):
        self.leaves = _leaves_of(shapes)
        index = {path: i for i, (path, _) in enumerate(self.leaves)}
        ids = _map_tree(
            lambda path, shp: np.full(shp, index[path], np.float64), shapes)
        flat = _map_tree(lambda _, shp: np.arange(
            int(np.prod(shp)), dtype=np.float64).reshape(shp), shapes)
        self.ids = _export_state_tree(ids, encoder_type)
        self.flat = _export_state_tree(flat, encoder_type)

    def views(self, key: str, p: torch.Tensor, blocks):
        ids = np.asarray(self.ids[key]).reshape(p.shape)
        flat = np.asarray(self.flat[key]).reshape(p.shape)
        out = []
        for a, b in blocks or [(0, p.shape[0] if p.dim() else 1)]:
            vid, vflat = ids[a:b], flat[a:b]
            path, shape = self.leaves[int(vid.flat[0])]
            origin = np.unravel_index(int(vflat.flat[0]), shape)
            axes = []
            for ax in range(vflat.ndim):
                if vflat.shape[ax] == 1:
                    axes.append(None)
                    continue
                step = [0] * vflat.ndim
                step[ax] = 1
                moved = np.unravel_index(int(vflat[tuple(step)]), shape)
                axes.append(next(k for k in range(len(shape))
                                 if moved[k] != origin[k]))
            out.append((path, tuple(shape), axes))
        return out


def _to_view(arr, axes, shape) -> np.ndarray:
    """A JAX array over the JAX axes ``axes`` (None: a size-1 axis it
    lacks) in the view's axis order, shaped ``shape``."""
    keep = [k for k in axes if k is not None]
    order = sorted(keep)
    arr = np.asarray(arr)
    # the JAX axes no view axis runs along have size 1
    arr = arr.reshape([arr.shape[k] for k in order])
    return np.transpose(arr, [order.index(k) for k in keep]).reshape(shape)


def _adafactor_view(fields, path, jdims, axes, view_shape, dims):
    """A view's (v_row, v_col, v) from its JAX leaf's moments (factored
    over ``jdims``; the view over ``dims``)."""
    v_row, v_col, v = (_get(fields[k], path) for k in ("v_row", "v_col",
                                                       "v"))
    if (jdims is None) != (dims is None):
        raise _Unmappable("a leaf factored in one layout only")
    if dims is None:
        return (np.zeros(1), np.zeros(1),
                _to_view(v, axes, view_shape))
    jd1, jd0 = jdims
    out = []
    for removed in dims[::-1]:          # port v_row drops d0, v_col d1
        # the JAX moment that averaged the same axis away
        src = v_row if axes[removed] == jd0 else v_col
        gone = jd0 if src is v_row else jd1
        rest = [a for i, a in enumerate(axes) if i != removed]
        rest = [a if a is None or a < gone else a - 1 for a in rest]
        shape = [s for i, s in enumerate(view_shape) if i != removed]
        out.append(_to_view(src, rest, shape))
    return out[0], out[1], np.zeros(1)


def _sm3_view(accs, axes, view_shape, layer: Optional[int] = None):
    """A view's sm3 accumulators from its JAX leaf's: one per JAX axis, or
    the whole accumulator of a 1-D leaf. ``layer``: the view's layer in a
    stacked leaf, whose [L]-axis accumulator comes first (the port's
    pipeline layout: that layer's entry, then one per axis of the view). A
    size-1 axis the JAX leaf lacks takes the maximum over everything."""
    accs = [np.asarray(a, np.float32) for a in accs]
    out = []
    if layer is not None:
        out.append(accs[0][layer:layer + 1])
        top, accs = accs[0].max(), accs[1:]
    elif len(view_shape) < 2:
        return [accs[0].reshape(view_shape)]
    else:
        top = accs[0].max()
    for ax, size in enumerate(view_shape):
        k = axes[ax]
        if k is None:
            out.append(np.array([top], np.float32))
        else:
            out.append(accs[0 if len(accs) == 1 else k].reshape(size))
    return out


# the fields of each name that are not shaped like their parameter
_SPECIAL = {"adafactor": ("v_row", "v_col", "v"), "sm3": ("mu",),
            "novograd": ("nu",)}


def _jax_state(stored) -> Tuple[Dict[str, Dict], Dict[str, np.ndarray]]:
    """The sidecar's optimizer leaves as ({field: nested tree}, {scalar
    field: value}) (the chain's index path dropped: a field names one
    state of the chain)."""
    fields, scalars = {}, {}
    for key, val in stored.items():
        m = _JAX_LEAF.fullmatch(key)
        if not m:
            continue
        if m.group(3):
            fields.setdefault(m.group(2), {})[m.group(3)] = val
        else:
            scalars[m.group(2)] = val
    return {f: _nest(v) for f, v in fields.items()}, scalars


def _split_layers(depth: int):
    """A stacked leaf's per-layer values: along its leading [L] axis, or
    the leaf itself for each layer where it has none (a placeholder or a
    statistic of the whole stack)."""
    def split(x):
        x = np.asarray(x)
        if x.ndim and x.shape[0] == depth and x.shape != (1,):
            return list(x)
        return [x] * depth
    return split


def _port_views(optimizer, model):
    """[(parameter, state key, leaf blocks)] of the optimizer's
    parameters."""
    names = {id(p): n for n, p in model.named_parameters()}
    blocks = getattr(optimizer, "leaf_blocks", {}) or {}
    return [(p, _state_dict_key(names[id(p)]), blocks.get(p))
            for g in optimizer.param_groups for p in g["params"]]


def _restore_prodigy(trees, scalars, model, optimizer) -> None:
    need = ("exp_avg", "exp_avg_sq", "s", "p0")
    if not all(k in trees for k in need) or not all(
            k in scalars for k in ("d", "d_max", "d_numerator", "step")):
        raise _Unmappable("not Prodigy's state")
    depth = _stacked_depth(trees["p0"])
    exported = {k: _export_state_tree(
        _unstack(trees[k], _split_layers(depth)), model.arch.encoder_type)
        for k in need}
    views = _port_views(optimizer, model)
    optimizer.state.clear()
    for p, key, _ in views:
        optimizer.state[p] = {
            k: torch.from_numpy(np.array(exported[k][key], np.float32))
            .reshape(p.shape).to(p.device) for k in need}
    f32 = dict(dtype=torch.float32, device=views[0][0].device)
    optimizer.state[views[0][0]].update(
        {k: torch.tensor(float(scalars[k]), **f32)
         for k in ("d", "d_max", "d_numerator")},
        k=torch.tensor(float(scalars["step"]), **f32))


def _restore_optax(trees, scalars, stored, model, optimizer,
                   pipeline: bool) -> None:
    from .train.optimizers import STACKED_STATE, _factored_dims
    name = optimizer.optax_name
    (group,) = optimizer.param_groups
    optimizer.state.clear()
    _, sts, _ = optimizer._prepare(group)
    rename = _PORT_KEY.get(name, {})
    want = {k for st in sts for k in st if k != "step"}
    have = {rename.get(f, f) for f in trees}
    if want != have:
        raise _Unmappable(f"fields {sorted(trees)}, the port's "
                          f"{sorted(want)}")
    special = _SPECIAL.get(name, ())
    plain = [f for f in trees if f not in special]
    depth = max(_stacked_depth(t) for t in trees.values()) if trees else 0
    if name in STACKED_STATE and bool(depth) != pipeline:
        raise _Unmappable(
            f"its {name} state is kept per "
            f"{'stacked' if depth else 'unstacked'} leaf, the run "
            f"{'has' if pipeline else 'has no'} pipeline parallelism")
    split = _split_layers(depth)
    enc = model.arch.encoder_type
    exported = {f: _export_state_tree(_unstack(trees[f], split), enc)
                for f in plain}
    views = _port_views(optimizer, model)
    if special and plain:
        leaf_map = _LeafMap(_map_tree(lambda _, x: np.shape(x), _unstack(
            trees[plain[0]], split)), enc)
    elif special:                   # adafactor without momentum
        leaf_map = _adafactor_leaf_map(trees, views, depth, group, enc)
    per_leaf = {f: _unstack(trees[f], split) for f in special} \
        if name == "adafactor" else {}
    lr = stored.get("opt::.hyperparams['learning_rate']")
    if lr is not None:
        group["lr"] = float(lr)
    count = int(stored.get("opt::.count", 0))
    for (p, key, blocks), st in zip(views, sts):
        st["step"] = torch.tensor(count, dtype=torch.int64)
        for f in plain:
            k = rename.get(f, f)
            st[k].copy_(torch.from_numpy(np.array(
                exported[f][key], np.float32)).reshape(p.shape))
        if not special:
            continue
        for j, (path, jshape, axes) in enumerate(
                leaf_map.views(key, p, blocks)):
            view_shape = optimizer._leaves(p, p)[j].shape
            if name == "adafactor":
                jdims = _factored_dims(jshape, group["factored"],
                                       group["min_dim_size_to_factor"])
                if _stacked_path(path, depth)[1] is not None:
                    jdims = _factored_dims(
                        (depth,) + jshape, group["factored"],
                        group["min_dim_size_to_factor"])
                    jdims = jdims and (jdims[0] - 1, jdims[1] - 1)
                got = _adafactor_view(per_leaf, path, jdims, axes,
                                      view_shape,
                                      optimizer._dims(group, p, view_shape))
                for k, arr in zip(("v_row", "v_col", "v"), got):
                    st[k][j] = torch.from_numpy(np.array(arr, np.float32)
                                                ).to(p.device)
            elif name == "novograd":
                nu = _get(trees["nu"], _stacked_path(path, depth)[0])
                st["nu"][j] = float(nu)
            else:                                       # sm3
                spath, layer = _stacked_path(path, depth)
                st["accumulators"][j] = [
                    torch.from_numpy(np.array(a, np.float32)).to(p.device)
                    for a in _sm3_view(_get(trees["mu"], spath), axes,
                                       view_shape, layer)]
    if name == "dadaptadamw":
        f32 = dict(dtype=torch.float32, device=views[0][0].device)
        for k in ("estim_lr", "numerator_weighted"):
            if k not in scalars:
                raise _Unmappable(f"no {k}")
            sts[0][k] = torch.tensor(float(scalars[k]), **f32)


def _stacked_path(path, depth: int):
    """An unstacked tree's path → (the stacked tree's path, the layer), or
    (path, None) when the tree is not stacked or the leaf not a layer's."""
    if depth and path[:2] == ("encoder", "layers"):
        return path[:2] + path[3:], path[2]
    return path, None


def _shape_tree(flat: Dict[tuple, tuple], depth: int):
    """{path: shape} of a (possibly stacked) tree → the unstacked tree of
    shapes."""
    items = []
    for path, shape in flat.items():
        paths = [path]
        if depth and path[:2] == ("encoder", "layers"):
            paths = [path[:2] + (i,) + path[2:] for i in range(depth)]
        items += [(q, shape) for q in paths]
    return _tree(items)


def restore_jax_train_state(model_path: str, model: BIOPhonemeTagger,
                            optimizer: torch.optim.Optimizer,
                            pipeline: bool = False) -> Optional[dict]:
    """Read the JAX package's ``.train.npz`` beside ``model_path`` into
    ``optimizer`` (over ``model``'s parameters): Prodigy's state, or any
    optax name's (``inject_hyperparams``' count and live learning rate;
    the chain's states by field, ``masked(set_to_zero)`` under a frozen
    encoder carrying none); per-leaf states (adafactor's factored moments,
    sm3's per-axis accumulators, novograd's moment) follow each JAX leaf
    onto the port's views of it (in_proj's three leaves on its row blocks,
    a transposed leaf's axes). A JAX PP run's stacked sidecar unstacks
    along ``[L]``; a state over the whole stack (sm3's, novograd's) maps
    onto a port run with pipeline parallelism (``pipeline``) only, as a
    non-stacked one onto a run without. Returns {"step", "scheduler"}
    when it did, None when there is no sidecar or it cannot map (another
    optimizer's state) — logged, and the optimizer left fresh. The JAX PRNG
    key is never mapped."""
    path = jax_sidecar_path(model_path)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as data:
        stored = {k: np.asarray(data[k]) for k in data.files}
    trees, scalars = _jax_state(stored)
    name = os.path.basename(path)
    kind = type(optimizer).__name__
    try:
        if isinstance(optimizer, Prodigy):
            _restore_prodigy(trees, scalars, model, optimizer)
        elif hasattr(optimizer, "optax_name"):
            _restore_optax(trees, scalars, stored, model, optimizer,
                           pipeline)
        else:
            raise _Unmappable("not a port optimizer")
    except _Unmappable as e:
        optimizer.state.clear()
        print(f"[INFO] {name}: a JAX optimizer state that does not map onto "
              f"the port's {kind} ({e}); the optimizer starts fresh")
        return None
    print(f"[INFO] {name}: restored the JAX run's {kind} state (step "
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
