"""Carry the JAX package's parameters into the port's modules.

The JAX param tree (``absolutetrack_tpu.models.umetrack.init_umetrack_params``
or a converted checkpoint) is nested dicts and lists of arrays: HWIO conv
weights, (in, out) linear weights, BN already folded. Convs become OIHW,
linear weights are transposed; ``export_jax_params`` goes back.

Tensors keyed by the model's parameter names (gradients, Adam's moments)
cross the same way (``export_jax_tensors``/``load_jax_tensors``), and so
does a whole train state (``export_jax_train_state``/``load_jax_train_state``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..training.optimizer import AdamState, GuardState
from ..training.train import TrainState
from ..utils.runtime import resolve_device
from .config import ModelConfig
from .layers import BasicBlock
from .umetrack import UmeTrackModel


def _copy(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    src = torch.from_numpy(np.array(src, dtype=np.float32))
    if src.shape != dst.shape:
        raise ValueError(f"{name}: JAX shape {tuple(src.shape)} != port shape {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def _conv(c: nn.Conv2d, p: dict, name: str) -> None:
    _copy(c.weight, np.asarray(p["w"]).transpose(3, 2, 0, 1), name + ".w")
    _copy(c.bias, np.asarray(p["b"]), name + ".b")


def _block(blk: BasicBlock, p: dict, name: str) -> None:
    _conv(blk.conv1, p["conv1"], name + ".conv1")
    _conv(blk.conv2, p["conv2"], name + ".conv2")
    if (blk.downsample is None) != ("downsample" not in p):
        raise ValueError(f"{name}: downsample present in only one tree")
    if blk.downsample is not None:
        _conv(blk.downsample, p["downsample"], name + ".downsample")


def _regressor(reg, p: dict, name: str) -> None:
    if len(reg.blocks) != len(p["blocks"]):
        raise ValueError(f"{name}: block count differs")
    for i, (blk, bp) in enumerate(zip(reg.blocks, p["blocks"])):
        _block(blk, bp, f"{name}.blocks{i}")
    _conv(reg.out, p["out"], name + ".out")


def load_jax_params(tree: dict, cfg: ModelConfig = ModelConfig(), device=None) -> UmeTrackModel:
    """A ``UmeTrackModel`` holding the weights of a JAX param tree."""
    model = UmeTrackModel(cfg, device="cpu")

    bb, pb = model.backbone, tree["backbone"]
    _conv(bb.stem, pb["stem"], "backbone.stem")
    for si, stage in enumerate(bb.stages):
        if len(stage) != len(pb[f"stage{si}"]):
            raise ValueError(f"backbone.stage{si}: block count differs")
        for bi, blk in enumerate(stage):
            _block(blk, pb[f"stage{si}"][bi], f"backbone.stage{si}.{bi}")
    _conv(bb.proj, pb["proj"], "backbone.proj")

    pf = tree["fusion"]
    if len(model.fusion.blocks) != len(pf["blocks"]):
        raise ValueError("fusion: block count differs")
    for i, c in enumerate(model.fusion.blocks):
        _conv(c, pf["blocks"][i], f"fusion.blocks{i}")
    _conv(model.fusion.final, pf["final"], "fusion.final")

    for i, c in enumerate(model.temporal.blocks):
        _conv(c, tree["temporal"]["blocks"][i], f"temporal.blocks{i}")

    fc = tree["skeleton_encoder"]["fc"]
    _copy(model.skeleton_encoder.fc.weight, np.asarray(fc["w"]).T, "skeleton_encoder.fc.w")
    _copy(model.skeleton_encoder.fc.bias, np.asarray(fc["b"]), "skeleton_encoder.fc.b")

    _regressor(model.regressor_k, tree["regressor_k"], "regressor_k")
    _regressor(model.regressor_u, tree["regressor_u"], "regressor_u")
    return model.to(resolve_device(device))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _conv_tree(c: nn.Conv2d) -> dict:
    return {"w": _np(c.weight).transpose(2, 3, 1, 0), "b": _np(c.bias)}


def _block_tree(blk: BasicBlock) -> dict:
    out = {"conv1": _conv_tree(blk.conv1), "conv2": _conv_tree(blk.conv2)}
    if blk.downsample is not None:
        out["downsample"] = _conv_tree(blk.downsample)
    return out


def _regressor_tree(reg) -> dict:
    return {"blocks": [_block_tree(b) for b in reg.blocks], "out": _conv_tree(reg.out)}


def export_jax_params(model: UmeTrackModel) -> dict:
    """The inverse of ``load_jax_params``: the model's weights as a JAX param
    tree (float32 numpy, HWIO convs, (in, out) linear weights), keys in the
    order of the JAX package's ``init_umetrack_params``."""
    bb = model.backbone
    backbone = {"stem": _conv_tree(bb.stem)}
    for si, stage in enumerate(bb.stages):
        backbone[f"stage{si}"] = [_block_tree(blk) for blk in stage]
    backbone["proj"] = _conv_tree(bb.proj)
    fc = model.skeleton_encoder.fc
    return {
        "backbone": backbone,
        "fusion": {"blocks": [_conv_tree(c) for c in model.fusion.blocks], "final": _conv_tree(model.fusion.final)},
        "temporal": {"blocks": [_conv_tree(c) for c in model.temporal.blocks]},
        "skeleton_encoder": {"fc": {"w": _np(fc.weight).T, "b": _np(fc.bias)}},
        "regressor_k": _regressor_tree(model.regressor_k),
        "regressor_u": _regressor_tree(model.regressor_u),
    }


def _carrier(cfg: ModelConfig) -> UmeTrackModel:
    """An f32 model on the CPU whose parameters hold tensors to carry."""
    return UmeTrackModel(dataclasses.replace(cfg, compute_dtype="float32"), device="cpu")


def export_jax_tensors(tensors: Dict[str, torch.Tensor], cfg: ModelConfig = ModelConfig()) -> dict:
    """Tensors keyed by ``UmeTrackModel`` parameter names (gradients,
    moments) as a JAX param tree, transposed as the weights are."""
    carrier = _carrier(cfg)
    with torch.no_grad():
        for name, p in carrier.named_parameters():
            p.copy_(tensors[name])
    return export_jax_params(carrier)


def load_jax_tensors(tree: dict, cfg: ModelConfig = ModelConfig(), device=None) -> Dict[str, torch.Tensor]:
    """The inverse of ``export_jax_tensors``: f32 tensors on ``device``
    (``cuda`` unless given), keyed by parameter name."""
    model = load_jax_params(tree, dataclasses.replace(cfg, compute_dtype="float32"), device=device)
    return {name: p.detach() for name, p in model.named_parameters()}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def export_jax_train_state(state: TrainState) -> TrainState:
    """A train state in the JAX package's layout, numpy leaves: the param
    tree, optax's ``ApplyIfFiniteState`` fields with the ``chain`` state as
    the tuple ``((), (AdamState(count, mu, nu), (), ()))`` (clip, adam,
    decay, scale: only adam keeps state), and the step. Named tuples
    serialize as their fields in order, tuples by position
    (``models/checkpoint.py::save_train_state``)."""
    cfg = state.params.cfg
    guard, adam = state.opt_state, state.opt_state.inner_state
    return TrainState(
        params=export_jax_params(state.params),
        opt_state=GuardState(
            notfinite_count=_host(guard.notfinite_count),
            last_finite=_host(guard.last_finite),
            total_notfinite=_host(guard.total_notfinite),
            inner_state=((), (AdamState(_host(adam.count), export_jax_tensors(adam.mu, cfg),
                                        export_jax_tensors(adam.nu, cfg)), (), ())),
        ),
        step=_host(state.step),
    )


def load_jax_train_state(tree, cfg: ModelConfig = ModelConfig(), device=None) -> TrainState:
    """A JAX train state (``TrainState(params, optax state, step)`` with
    numpy or JAX leaves, or ``export_jax_train_state``'s) as the port's, on
    ``device`` (``cuda`` unless given)."""
    device = resolve_device(device)
    guard = tree.opt_state
    adam = guard.inner_state[1][0]

    def scalar(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return TrainState(
        params=load_jax_params(tree.params, cfg, device=device),
        opt_state=GuardState(
            notfinite_count=scalar(guard.notfinite_count, torch.int32),
            last_finite=scalar(guard.last_finite, torch.bool),
            total_notfinite=scalar(guard.total_notfinite, torch.int32),
            inner_state=AdamState(
                count=scalar(adam.count, torch.int32),
                mu=load_jax_tensors(adam.mu, cfg, device),
                nu=load_jax_tensors(adam.nu, cfg, device),
            ),
        ),
        step=scalar(tree.step, torch.int32),
    )
