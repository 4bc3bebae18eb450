"""Parameters and optimizer state between the reference package's layout
and the port's.

``params_from_jax`` takes the reference's parameter pytree as numpy
arrays (nested dicts; per-layer leaves stacked on a leading [L] axis)
and returns the port's model for ``cfg.family`` (``DenseLM``,
``MambaLM``, ``HybridLM`` or ``EncDecLM``) holding the same values, the
stacked axis split across blocks (the encdec's ``enc_layers`` and
``dec_layers`` stacks, with the decoder's ``xattn`` and ``ln_x``, across
its two layer lists); leaves outside the layer stacks (the hybrid's
shared block, ``shared/attn/wq``, the encdec's ``frontend_proj``,
``ln_enc`` and ``ln_dec`` ...) come across unsplit.  A MoE block's
leaves (``layers/moe/router`` [L, d, E], the expert stacks
``layers/moe/w{g,u,d}`` [L, E, K, N] and the shared experts'
``layers/moe/shared/*``) come across the same way.  Leaves may be
float32, bfloat16 passed as a ``uint16`` view, or int16/int32 posit
patterns of prequantized weights; each keeps its dtype.  With the same parameters both packages compute
the same function.

``params_to_jax`` is its inverse: the port's model (or a paper model's
dict of tensors) as the reference's tree of numpy arrays, per-layer
leaves stacked on [L] and bf16 as a ``uint16`` view.  The optimizer
state goes the same way (``opt_state_to_jax`` / ``opt_state_from_jax``):
its per-parameter trees take the parameters' layout.  ``named_tree``
builds the same tree with torch leaves, which the checkpoint writes, and
``load_named`` copies a reference tree back into tensors in place.  This
module imports numpy and torch only.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.prequant import layer_index, param_path
from repro_torch.device import resolve_device
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.mamba_lm import MambaLM
from repro_torch.models.transformer import DenseLM

#: the port's model class of each family
MODEL_CLASSES = {"dense": DenseLM, "moe": DenseLM, "vlm": DenseLM, "ssm": MambaLM,
                 "hybrid": HybridLM, "encdec": EncDecLM}


def _leaf(tree: Mapping, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _to_torch(leaf: np.ndarray) -> torch.Tensor:
    arr = np.array(leaf)  # a writable copy
    if arr.dtype == np.uint16:  # bfloat16 bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype not in (np.float32, np.int16, np.int32):
        raise TypeError(f"unsupported leaf dtype {arr.dtype}")
    return torch.from_numpy(arr)


@torch.no_grad()
def params_from_jax(tree: Mapping, cfg: ModelConfig, device=None) -> nn.Module:
    """Build the port's model for ``cfg`` from a reference parameter
    pytree of numpy arrays, on ``device`` (CUDA by default)."""
    device = resolve_device(device)
    model = MODEL_CLASSES[cfg.family](cfg, generator=torch.Generator(),
                                      device=torch.device("meta"))
    for name, _ in list(model.named_parameters()):
        leaf = _leaf(tree, param_path(name))
        if layer_index(name) is not None:
            leaf = np.asarray(leaf)[layer_index(name)]
        mod_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(mod_name) if mod_name else model
        value = _to_torch(np.asarray(leaf)).to(device)
        setattr(owner, attr, nn.Parameter(value, requires_grad=False))
    return model


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _set_leaf(tree: dict, path: str, value) -> None:
    node = tree
    *parents, last = path.split("/")
    for part in parents:
        node = node.setdefault(part, {})
    node[last] = value


def named_tree(named: Mapping[str, torch.Tensor],
               leaf: Callable = lambda t: t.detach().cpu()) -> Dict:
    """The reference's nested tree of the tensors in ``named`` (port
    parameter names: ``blocks.{i}.X`` stacked on a leading [L] axis at
    ``layers/X``, ``enc_layers.{i}.X`` at ``enc_layers/X`` and
    ``dec_layers.{i}.X`` at ``dec_layers/X``, other names at their path),
    each leaf through ``leaf``."""
    stacked: Dict[str, list] = {}
    tree: Dict = {}
    for name, t in named.items():
        path = param_path(name)
        if layer_index(name) is not None:
            stacked.setdefault(path, []).append((layer_index(name), t))
        else:
            _set_leaf(tree, path, leaf(t))
    for path, items in stacked.items():
        items.sort(key=lambda it: it[0])
        _set_leaf(tree, path, leaf(torch.stack([t.detach() for _, t in items])))
    return tree


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def params_to_jax(params) -> Dict:
    """The reference's parameter tree (numpy; bf16 as ``uint16``) of the
    port's model or of a dict of tensors: the inverse of
    :func:`params_from_jax`."""
    return named_tree(_named(params), _to_numpy)


def opt_state_to_jax(state) -> Dict:
    """The reference's optimizer state tree (numpy) of the port's state:
    ``{"m", "step", "v"}`` or ``{"mu", "step"}``, each per-parameter tree
    in the parameters' layout."""
    out = {k: named_tree(v, _to_numpy) for k, v in state.items() if k != "step"}
    out["step"] = np.asarray(int(state["step"]), np.int32)
    return out


@torch.no_grad()
def load_named(tree: Mapping, named: Mapping[str, torch.Tensor]) -> None:
    """Copy the reference tree's leaves into the tensors of ``named`` in
    place (each keeps its device and dtype; shapes must agree)."""
    for name, t in named.items():
        leaf = np.asarray(_leaf(tree, param_path(name)))
        if layer_index(name) is not None:
            leaf = leaf[layer_index(name)]
        value = _to_torch(leaf)
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} in the tree, "
                             f"{tuple(t.shape)} here")
        t.copy_(value.to(t.dtype))


def opt_state_from_jax(tree: Mapping, params) -> Dict:
    """The port's optimizer state from the reference's state tree, on the
    devices of ``params``."""
    named = _named(params)
    state = {}
    for key in tree:
        if key == "step":
            state["step"] = torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32)
            continue
        part = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in named.items()}
        load_named(tree[key], part)
        state[key] = part
    return state
