"""Parameters from the reference package's layout into the port's model.

``params_from_jax`` takes the reference's parameter pytree as numpy
arrays (nested dicts; per-layer leaves stacked on a leading [L] axis)
and returns the port's ``DenseLM`` holding the same values, the stacked
axis split across blocks.  A MoE block's leaves (``layers/moe/router``
[L, d, E], the expert stacks ``layers/moe/w{g,u,d}`` [L, E, K, N] and
the shared experts' ``layers/moe/shared/*``) come across the same way.  Leaves may be float32, bfloat16 passed as a
``uint16`` view, or int16/int32 posit patterns of prequantized weights;
each keeps its dtype.  With the same parameters both packages compute
the same function.  This module imports numpy and torch only.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.prequant import param_path
from repro_torch.device import resolve_device
from repro_torch.models.transformer import DenseLM


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
def params_from_jax(tree: Mapping, cfg: ModelConfig, device=None) -> DenseLM:
    """Build the port's model for ``cfg`` from a reference parameter
    pytree of numpy arrays, on ``device`` (CUDA by default)."""
    device = resolve_device(device)
    model = DenseLM(cfg, generator=torch.Generator(), device=torch.device("meta"))
    for name, _ in list(model.named_parameters()):
        leaf = _leaf(tree, param_path(name))
        if name.startswith("blocks."):
            leaf = np.asarray(leaf)[int(name.split(".")[1])]
        mod_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(mod_name) if mod_name else model
        value = _to_torch(np.asarray(leaf)).to(device)
        setattr(owner, attr, nn.Parameter(value, requires_grad=False))
    return model
