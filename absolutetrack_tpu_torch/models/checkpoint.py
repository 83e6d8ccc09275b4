"""Param and train-state checkpoints (port of ``save_params``,
``load_params``, ``load_any``, ``save_train_state`` and ``load_train_state``
of ``absolutetrack_tpu/models/checkpoint.py``).

The format is the JAX package's own: flax's msgpack of the JAX-layout
param tree (lists stored as maps keyed "0", "1", ...), read and written
by the port's codec (``utils/flax_msgpack.py``), so a file moves both ways
between the packages and the port writes the JAX package's bytes for the
same tree.
``load_any`` also reads the reference's torch state dict. Trees here have
float32 numpy leaves; ``models/params.py::load_jax_params`` builds the
model from one.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
from torch import nn

from ..utils import flax_msgpack
from .config import ModelConfig


def _state_dict(tree):
    """The state dict that the JAX package's ``save_params`` serializes: a
    dict's keys sorted (as ``jax.tree.map`` rebuilds dicts), lists and
    tuples as maps keyed by position, named tuples as maps of their fields
    in declaration order (as flax stores them)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _state_dict(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {str(k): _state_dict(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return np.asarray(tree)


def _restore(template, state, path: str = ""):
    """``state`` in the shape of ``template``, as flax's ``from_state_dict``
    restores it; a missing key, a list of another length or a leaf of
    another shape raises."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        fields = _restore(dict(zip(template._fields, template)), state, path)
        return type(template)(**fields)
    if isinstance(template, dict):
        if not isinstance(state, dict):
            raise ValueError(f"{path or '/'}: expected a map, got {type(state).__name__}")
        missing = set(map(str, template)) - set(state)
        if missing:
            raise ValueError(f"{path or '/'}: the checkpoint lacks {sorted(missing)}")
        return {k: _restore(v, state[str(k)], f"{path}/{k}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(state, dict) or len(state) != len(template):
            n = len(state) if isinstance(state, dict) else type(state).__name__
            raise ValueError(f"{path}: the list has {len(template)} entries, the checkpoint {n}")
        return type(template)(_restore(v, state[str(i)], f"{path}/{i}") for i, v in enumerate(template))
    if not isinstance(state, np.ndarray) or state.shape != template.shape:
        got = state.shape if isinstance(state, np.ndarray) else type(state).__name__
        raise ValueError(f"{path}: expected an array of shape {template.shape}, got {got}")
    return state


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)  # atomic publish


def save_params(path: str, params) -> None:
    """Write a model (``UmeTrackModel``) or a JAX-layout param tree as flax
    msgpack, atomically (through ``path + ".tmp"``)."""
    from .params import export_jax_params

    tree = export_jax_params(params) if isinstance(params, nn.Module) else params
    _write(path, flax_msgpack.packb(_state_dict(tree)))


def load_params(path: str, cfg: ModelConfig = ModelConfig()) -> Dict:
    """A flax-msgpack param file (the JAX package's ``save_params``) -> tree."""
    from .params import export_jax_params
    from .umetrack import UmeTrackModel

    template = export_jax_params(UmeTrackModel(cfg, device="cpu"))
    with open(path, "rb") as f:
        state = flax_msgpack.unpackb(f.read())
    return _restore(template, state)


def load_any(path: str, cfg: ModelConfig = ModelConfig()) -> Dict:
    """A flax-msgpack checkpoint or the reference's torch state dict.

    Dispatch: torch extensions (.torch/.pt/.pth) go to the converter;
    otherwise the file's magic bytes are sniffed -- torch zip archives
    start with ``PK\\x03\\x04`` and legacy torch pickles with ``\\x80`` and
    a protocol byte 2-5 -- before falling back to msgpack.
    """
    from .weights import load_torch_checkpoint

    if path.endswith((".torch", ".pt", ".pth")):
        return load_torch_checkpoint(path, cfg)
    with open(path, "rb") as f:
        magic = f.read(4)
    # a lone \x80 is also msgpack's empty fixmap, so check the protocol byte too
    legacy_pickle = len(magic) >= 2 and magic[0] == 0x80 and magic[1] in (2, 3, 4, 5)
    if magic.startswith(b"PK\x03\x04") or legacy_pickle:
        return load_torch_checkpoint(path, cfg)
    try:
        return load_params(path, cfg)
    except Exception as e:
        raise ValueError(
            f"{path}: failed to load as a native flax-msgpack checkpoint "
            f"(magic bytes {magic!r} are not a torch zip/pickle either). "
            "If the file IS a native checkpoint, the configured "
            "architecture likely does not match the one it was saved from "
            f"(cfg={cfg}); otherwise the supported formats are native "
            ".msgpack from save_params or a torch state dict "
            "(.torch/.pt/.pth). Original error follows."
        ) from e


def save_train_state(path: str, state) -> None:
    """Checkpoint a whole ``TrainState`` (params, the optimizer's guard
    fields, moments and count, the step) for resumable training, in the
    JAX package's bytes (``save_train_state`` there: flax msgpack of the
    state, with optax's state layout)."""
    from .params import export_jax_train_state

    _write(path, flax_msgpack.packb(_state_dict(export_jax_train_state(state))))


def load_train_state(path: str, template):
    """Restore a ``TrainState`` saved by either package's
    ``save_train_state``; ``template`` is a train state of the same
    architecture, and the result lives on its model's device."""
    from .params import export_jax_train_state, load_jax_train_state

    with open(path, "rb") as f:
        state = flax_msgpack.unpackb(f.read())
    tree = _restore(export_jax_train_state(template), state)
    return load_jax_train_state(tree, template.params.cfg, device=template.params.device)
