"""Optimizers (SGD / Nesterov / Adam / AdamW), port of
``repro/optim/optimizers.py``.

The paper's experiments use SGD, Nesterov and Adam (Table I); AdamW is
the default for the LM-scale runs.  Parameters are a mapping of name ->
tensor (``dict(model.named_parameters())`` or a paper model's dict), and
the state holds one f32 tensor per parameter and name.  The update runs
parameter by parameter, in place: gradients are clipped by their global
norm, the master math is f32, and each parameter is cast back to its
storage dtype.  No f32 copy of all gradients is held at once.

The reference's ``state_shardings`` (ZeRO-1 sharding of the state over
the data axis) comes with the training side of tensor parallelism
(``ROADMAP.md``, queue 1, item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adam | sgd | nesterov
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 1.0


def named_params(params) -> Dict[str, torch.Tensor]:
    """name -> tensor for a model (its float parameters) or a mapping."""
    if isinstance(params, nn.Module):
        return {n: p for n, p in params.named_parameters() if p.is_floating_point()}
    return dict(params)


def init_state(cfg: OptConfig, params):
    named = named_params(params)

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in named.items()}

    step = torch.zeros((), dtype=torch.int32)
    if cfg.name in ("adam", "adamw"):
        return {"m": zeros(), "v": zeros(), "step": step}
    if cfg.name in ("sgd", "nesterov"):
        return {"mu": zeros(), "step": step}
    raise ValueError(cfg.name)


def global_norm(grads: Mapping[str, Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in f32 (one leaf's f32
    copy at a time); a ``None`` gradient counts as zero."""
    total = None
    for g in grads.values():
        if g is None:
            continue
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq.to(total.device)
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads: Mapping[str, Optional[torch.Tensor]],
                  state, lr_scale: float = 1.0):
    """One optimizer step, in place.  Returns (params, state).

    ``grads`` maps each parameter's name to its gradient or ``None`` (no
    gradient reached it, as under ``plam_sim``, whose products go through
    integer patterns): the reference's zero gradient.
    """
    named = named_params(params)
    f32 = torch.float32
    dev = next(iter(named.values())).device
    gnorm = global_norm(grads).to(dev)
    clip = torch.minimum(torch.ones((), dtype=f32, device=dev),
                         cfg.grad_clip / (gnorm + 1e-12))
    step = state["step"] + 1
    lr = cfg.lr * lr_scale
    stepf = step.to(f32)
    if cfg.name in ("adam", "adamw"):
        b1, b2 = cfg.beta1, cfg.beta2
        bc1 = (1 - torch.tensor(b1, dtype=f32) ** stepf).to(dev)
        bc2 = (1 - torch.tensor(b2, dtype=f32) ** stepf).to(dev)
    for name, p in named.items():
        g = grads.get(name)
        g32 = None if g is None else g.to(f32) * clip
        if cfg.name in ("adam", "adamw"):
            m, v = state["m"][name], state["v"][name]
            m.mul_(b1)
            v.mul_(b2)
            if g32 is not None:
                m.add_((1 - b1) * g32)
                v.add_((1 - b2) * g32 * g32)
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.name == "adamw" and cfg.weight_decay:
                u = u + cfg.weight_decay * p.to(f32)
        else:
            mu = state["mu"][name]
            mu.mul_(cfg.momentum)
            if g32 is not None:
                mu.add_(g32)
            if cfg.name == "nesterov":
                u = cfg.momentum * mu if g32 is None else g32 + cfg.momentum * mu
            else:
                u = mu
        p.copy_((p.to(f32) - lr * u).to(p.dtype))
        del g32, u
    state["step"] = step
    return params, state
