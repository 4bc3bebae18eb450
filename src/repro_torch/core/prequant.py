"""Prequantized posit weight storage: encode once, serve forever.

Port of ``repro/core/prequant.py`` over an ``nn.Module`` model.
``quantize_params`` walks the model's parameters, maps each weight to
its matmul site role, and where the numerics policy resolves that site
to a posit mode (``posit_quant`` / ``plam_sim``) replaces the weight,
in place and one tensor at a time, with its Posit<n,es> patterns
(encoded by the codec kernel on the card; int16 for n <= 16).  A MoE
block's expert stack [E, K, N] is one tensor, encoded in one call; its
f32 router resolves to ``f32`` under the policy's baseline rule and
stays as it is.
``core.modes.nmatmul`` recognises integer weights and consumes them
without re-encoding.

Parameter paths are the reference's ``/``-joined pytree paths with the
stacked layer axis folded away (``blocks.3.attn.wq`` is
``layers/attn/wq``), so ``meta`` matches the reference key for key.
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

import torch
from torch import nn

from .modes import NumericsConfig, _codec_float
from .policy import layer_segments, site_for

# Parameter path -> site role (the reference's table).
_PATH_ROLES: Tuple[Tuple[str, str], ...] = (
    (r"(^|/)xattn/w[qkv]$", "attn.cross.qkv"),
    (r"(^|/)xattn/wo$", "attn.cross.out"),
    (r"(^|/)attn/w[qkv]$", "attn.qkv"),
    (r"(^|/)attn/wo$", "attn.out"),
    (r"(^|/)moe/router$", "moe.router"),
    (r"(^|/)moe/wu$", "moe.expert.up"),
    (r"(^|/)moe/wg$", "moe.expert.gate"),
    (r"(^|/)moe/wd$", "moe.expert.down"),
    (r"(^|/)moe/shared/wu$", "moe.shared.up"),
    (r"(^|/)moe/shared/wg$", "moe.shared.gate"),
    (r"(^|/)moe/shared/wd$", "moe.shared.down"),
    (r"(^|/)mlp/wu$", "mlp.up"),
    (r"(^|/)mlp/wg$", "mlp.gate"),
    (r"(^|/)mlp/wd$", "mlp.down"),
    (r"(^|/)mamba/in_proj$", "ssm.proj.in"),
    (r"(^|/)mamba/out_proj$", "ssm.proj.out"),
    (r"^shared/out_proj$", "hybrid.proj"),
    (r"^frontend_proj$", "frontend"),
    (r"^unembed$", "lm_head"),
)

_POSIT_MODES = ("posit_quant", "plam_sim")


def param_role(path: str) -> Optional[str]:
    """Site role for a '/'-joined parameter path, or None (skip)."""
    for pat, role in _PATH_ROLES:
        if re.search(pat, path):
            return role
    return None


#: the port's layer lists -> the reference's stacked [L] pytree keys
_STACKS = {"blocks": "layers", "enc_layers": "enc_layers", "dec_layers": "dec_layers"}


def layer_index(name: str) -> Optional[int]:
    """The layer of a parameter in a layer list (``blocks.3.attn.wq`` ->
    3, ``dec_layers.1.xattn.wk`` -> 1), None outside the stacks."""
    parts = name.split(".")
    return int(parts[1]) if parts[0] in _STACKS else None


def param_path(name: str) -> str:
    """torch parameter name -> the reference's pytree path
    (``blocks.3.attn.wq`` -> ``layers/attn/wq``, ``enc_layers.0.mlp.wu``
    -> ``enc_layers/mlp/wu``, ``ln_f.scale`` -> ``ln_f/scale``)."""
    parts = name.split(".")
    if parts[0] in _STACKS:
        parts = [_STACKS[parts[0]], *parts[2:]]
    return "/".join(parts)


def _site_cfg_if_uniform(cfg, role: str, layered: bool) -> Optional[NumericsConfig]:
    """Resolve ``role`` under cfg.numerics, requiring layer-uniformity
    (the reference stacks per-layer weights in one array of one dtype,
    so a site is prequantized only when every layer resolves to the same
    posit config; the port keeps that rule so both agree)."""
    if not layered:
        segs = [(0, 1, None)]
        n_layers = None
    else:
        n_layers = cfg.n_layers
        segs = layer_segments(cfg.numerics, n_layers)
    resolved = [
        site_for(cfg.numerics, role, start if layered else None, n_layers)
        for start, _, _ in segs
    ]
    first = resolved[0]
    if any(r != first for r in resolved[1:]):
        return None
    return first


def _owner(model: nn.Module, name: str):
    mod_name, _, attr = name.rpartition(".")
    return (model.get_submodule(mod_name) if mod_name else model), attr


@torch.no_grad()
def quantize_params(cfg, model: nn.Module, *, pack: bool = True,
                    use_kernel: Optional[bool] = None):
    """Encode policy-selected weights of ``model`` to posit patterns, in
    place.  Returns ``(model, meta)`` where ``meta`` maps parameter path
    -> ``{"role", "mode", "n", "es"}`` for every quantized site.  Tied
    embeddings are never quantized."""
    from repro_torch.kernels.posit_codec import posit_encode

    meta = {}
    # by name, so each replaced weight is freed before the next is encoded
    for name in [n for n, _ in model.named_parameters()]:
        param = model.get_parameter(name)
        path = param_path(name)
        role = param_role(path)
        if role is None or not param.is_floating_point():
            continue
        site_cfg = _site_cfg_if_uniform(cfg, role, path.startswith("layers/"))
        if site_cfg is None or site_cfg.mode not in _POSIT_MODES:
            continue
        spec = site_cfg.spec
        out_dtype = torch.int16 if pack and spec.n <= 16 else torch.int32
        x = _codec_float(param.detach())
        bits = posit_encode(x.contiguous(), spec, out_dtype=out_dtype,
                            use_kernel=use_kernel)
        owner, attr = _owner(model, name)
        setattr(owner, attr, nn.Parameter(bits, requires_grad=False))
        del param, x, bits
        meta[path] = {"role": role, "mode": site_cfg.mode, "n": spec.n, "es": spec.es}
    return model, meta


@torch.no_grad()
def dequantize_params(model: nn.Module, meta, dtype=torch.float32):
    """Inverse of :func:`quantize_params` (to the posit-grid values), in
    place, through the codec kernel's decode (its plain version on the
    CPU); everything needed to decode is in ``meta``."""
    from repro_torch.kernels.posit_codec import posit_decode
    from repro_torch.numerics import PositSpec

    for name, param in list(model.named_parameters()):
        info = meta.get(param_path(name))
        if info is None or param.is_floating_point():
            continue
        vals = posit_decode(param.detach().contiguous(),
                            PositSpec(info["n"], info["es"])).to(dtype)
        owner, attr = _owner(model, name)
        setattr(owner, attr, nn.Parameter(vals, requires_grad=False))
    return model
