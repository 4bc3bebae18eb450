"""Greedy mixed-numerics calibration: how much PLAM can a model take?

Port of ``repro/numerics/calibrate.py``.  Given a model, an eval batch
and an accuracy budget, :func:`calibrate` walks candidate sites in order
of estimated multiplier-cost savings (widest hardware impact first) and
keeps the PLAM assignment whenever the eval loss stays within budget;
sites that bust the budget fall back to exact posit, then to the base
config.  The result is a reusable :class:`NumericsPolicy` plus a report
row per decision, and the policy saves as the reference's
``"plam-numerics-policy/v1"`` JSON artifact, which either package loads.

Each trial evaluates ``train_loss`` under its policy, on the model's
device: on the card, ``plam_sim`` sites run the codec kernel (weight
encode) and the PLAM matmul kernel.

The multiplier-cost proxy is the reference's unit-gate model (array
multiplier ~ quadratic in fraction bits; PLAM ~ one adder, linear),
weighted by per-token MAC counts per site (:func:`site_macs`, which the
serving metrics registry also reads): an ordering heuristic and a
reporting column, not a synthesis result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.modes import NumericsConfig
from repro_torch.core.policy import (
    NumericsPolicy,
    Rule,
    as_policy,
    cfg_spec_str,
    layer_segments,
    load_policy_arg,
    parse_cfg_spec,
    policy_to_dict,
    policy_to_str,
    site,
    site_for,
)

# ---------------------------------------------------------------------------
# multiplier-cost model (unit-gate proxy, per scalar multiply)
# ---------------------------------------------------------------------------

_FA = 7.0  # full-adder gate equivalents


def _codec_cost(n: int) -> float:
    # decode+encode: complement + LZC + two shifters + two adders
    return 2 * (_FA * n + 3.0 * n + 3.0 * n * max(1, math.ceil(math.log2(n))))


def unit_mult_cost(cfg: NumericsConfig) -> float:
    """Unit-gate area proxy for one scalar multiply under ``cfg``."""
    if cfg.mode in ("f32", "mitchell_f32"):
        m = 24  # f32 significand
        return m * m + _FA * m * (m - 2)
    if cfg.mode == "bf16":
        m = 8
        return m * m + _FA * m * (m - 2)
    fb = cfg.n - 3 - cfg.es
    if cfg.mode == "posit_quant":  # exact posit multiplier
        m = fb + 1
        return _codec_cost(cfg.n) + m * m + _FA * m * (m - 2)
    if cfg.mode == "plam_sim":  # PLAM: the one adder replacing the mult
        w = fb + cfg.es + math.ceil(math.log2(cfg.n))
        return _codec_cost(cfg.n) + _FA * w
    raise ValueError(cfg.mode)


# ---------------------------------------------------------------------------
# per-site MAC counts (per token, forward pass)
# ---------------------------------------------------------------------------


def site_macs(cfg) -> Dict[str, float]:
    """Approximate per-token MACs for every matmul site of ``cfg``.

    Layer counts multiply in; role groups are summed leaves.
    """
    d, l = cfg.d_model, cfg.n_layers
    hd = cfg.hd
    macs: Dict[str, float] = {}
    if cfg.family in ("dense", "moe", "vlm", "hybrid"):
        n_attn = l if cfg.family != "hybrid" else max(
            1, l // max(cfg.shared_attn_every, 1))
        dd = d if cfg.family != "hybrid" else 2 * d
        macs["attn.qkv"] = n_attn * dd * (cfg.n_heads + 2 * cfg.n_kv) * hd
        macs["attn.out"] = n_attn * cfg.n_heads * hd * dd
    if cfg.family in ("dense", "vlm") or (cfg.family == "hybrid"):
        d_in = d if cfg.family != "hybrid" else 2 * d
        n_mlp = l if cfg.family != "hybrid" else max(
            1, l // max(cfg.shared_attn_every, 1))
        macs["mlp.up"] = n_mlp * d_in * cfg.d_ff
        if cfg.glu:
            macs["mlp.gate"] = n_mlp * d_in * cfg.d_ff
        macs["mlp.down"] = n_mlp * cfg.d_ff * d_in
    if cfg.family == "moe":
        macs["moe.router"] = l * d * cfg.n_experts
        e = l * cfg.top_k * d * cfg.moe_d_ff
        macs["moe.expert.up"] = e
        macs["moe.expert.gate"] = e if cfg.glu else 0.0
        macs["moe.expert.down"] = e
        if cfg.n_shared_experts:
            s = l * d * cfg.moe_d_ff * cfg.n_shared_experts
            macs["moe.shared.up"] = s
            macs["moe.shared.gate"] = s if cfg.glu else 0.0
            macs["moe.shared.down"] = s
    if cfg.family in ("ssm", "hybrid"):
        di = cfg.ssm_expand * d
        nh = di // cfg.ssm_head_dim
        macs["ssm.proj.in"] = l * d * (2 * di + 2 * cfg.ssm_state + nh)
        macs["ssm.proj.out"] = l * di * d
    if cfg.family == "hybrid":
        macs["hybrid.proj"] = max(1, l // max(cfg.shared_attn_every, 1)) * 2 * d * d
    if cfg.family == "encdec":
        ltot = cfg.enc_layers + cfg.dec_layers
        macs["attn.qkv"] = ltot * d * (cfg.n_heads + 2 * cfg.n_kv) * hd
        macs["attn.out"] = ltot * cfg.n_heads * hd * d
        macs["attn.cross.qkv"] = cfg.dec_layers * d * (cfg.n_heads + 2 * cfg.n_kv) * hd
        macs["attn.cross.out"] = cfg.dec_layers * cfg.n_heads * hd * d
        macs["mlp.up"] = ltot * d * cfg.d_ff
        if cfg.glu:
            macs["mlp.gate"] = ltot * d * cfg.d_ff
        macs["mlp.down"] = ltot * cfg.d_ff * d
        if cfg.frontend_dim:
            macs["frontend"] = cfg.frontend_dim * d
    macs["lm_head"] = d * cfg.vocab
    return {k: v for k, v in macs.items() if v > 0}


def _layer_free_roles(cfg) -> frozenset:
    """Roles the models resolve without a layer index (so layers[] rules
    never apply): heads and frontends always, plus the hybrid family's
    shared attention/MLP block."""
    roles = {"lm_head", "frontend", "hybrid.proj"}
    if cfg.family in ("hybrid", "encdec"):
        roles |= {r for r in site_macs(cfg) if r.startswith(("attn.", "mlp."))}
    return frozenset(roles)


def _role_unit_cost(cfg, numerics, role, layer_free: bool) -> float:
    """Unit multiplier cost for one role, averaged over the layer stack
    when layer-range rules make it layer-dependent."""
    if layer_free:
        return unit_mult_cost(site_for(numerics, role, None, cfg.n_layers))
    total = 0.0
    for _, size, bound in layer_segments(numerics, cfg.n_layers):
        total += size * unit_mult_cost(site(bound, role))
    return total / cfg.n_layers


def estimate_cost(cfg, numerics=None) -> float:
    """Sum over sites of MACs x unit multiplier cost under ``numerics``
    (default cfg.numerics).  Comparable across policies of the SAME model;
    layer-range rules are averaged over the stack."""
    numerics = cfg.numerics if numerics is None else numerics
    layer_free = _layer_free_roles(cfg)
    total = 0.0
    for role, macs in site_macs(cfg).items():
        total += macs * _role_unit_cost(cfg, numerics, role, role in layer_free)
    return total


# ---------------------------------------------------------------------------
# greedy calibration
# ---------------------------------------------------------------------------


def default_candidate_sites(cfg) -> Tuple[str, ...]:
    """Role groups the greedy walk may reassign, for this family."""
    roles = list(site_macs(cfg))
    groups = []
    for g in ("mlp", "moe.expert", "moe.shared", "attn", "ssm.proj"):
        if any(r == g or r.startswith(g + ".") for r in roles):
            groups.append(g)
    if "lm_head" in roles:
        groups.append("lm_head")
    return tuple(groups)


def _group_macs(roles_macs: Dict[str, float], group: str) -> float:
    return sum(m for r, m in roles_macs.items() if r == group or r.startswith(group + "."))


@dataclasses.dataclass
class CalibrationResult:
    policy: NumericsPolicy
    base_loss: float
    budget: float
    decisions: List[dict]

    @property
    def policy_str(self) -> str:
        return policy_to_str(self.policy)


@torch.no_grad()
def _eval_loss(cfg, model, batch) -> float:
    from repro_torch.models.registry import build

    return float(build(cfg).train_loss(model, batch))


def calibrate(
    cfg,
    model,
    batch,
    *,
    budget: float = 0.02,
    base: str = "f32",
    target: str = "plam_sim:16:1",
    fallback: Optional[str] = "posit_quant:16:1",
    sites: Optional[Sequence[str]] = None,
) -> CalibrationResult:
    """Greedy budgeted site walk over ``model`` (the port's model, on its
    device) and ``batch`` ({tokens, labels}).  Returns the calibrated
    policy.

    budget: max relative eval-loss increase vs the all-``base`` policy.
    Sites are visited in descending estimated multiplier-cost savings;
    each keeps the ``target`` (PLAM) assignment if the loss stays within
    budget, else tries ``fallback`` (exact posit), else reverts to
    ``base``.  Each trial's loss is in its decision's ``trials``.
    """
    base_cfg = parse_cfg_spec(base)
    target_cfg = parse_cfg_spec(target)
    fb_cfg = None if fallback is None else parse_cfg_spec(fallback)
    sites = tuple(sites) if sites is not None else default_candidate_sites(cfg)

    roles_macs = site_macs(cfg)
    savings = {
        g: _group_macs(roles_macs, g) * (unit_mult_cost(base_cfg) - unit_mult_cost(target_cfg))
        for g in sites
    }
    order = sorted(sites, key=lambda g: -savings[g])

    def policy_of(assign: Dict[str, NumericsConfig]) -> NumericsPolicy:
        rules = [Rule(role="", cfg=base_cfg)]
        rules += [Rule(role=g, cfg=c) for g, c in assign.items()]
        return NumericsPolicy(rules=tuple(rules))

    base_loss = _eval_loss(cfg.with_numerics(policy_of({})), model, batch)
    limit = base_loss + abs(base_loss) * budget

    assign: Dict[str, NumericsConfig] = {}
    decisions = []
    current_loss = base_loss  # loss of the configuration actually kept
    for g in order:
        choice, trials = base_cfg, []
        for cand in ([target_cfg, fb_cfg] if fb_cfg is not None else [target_cfg]):
            trial = dict(assign)
            trial[g] = cand
            loss = _eval_loss(cfg.with_numerics(policy_of(trial)), model, batch)
            trials.append({"cfg": cfg_spec_str(cand), "loss": loss})
            if loss <= limit:
                choice = cand
                current_loss = loss
                break
        if choice is not base_cfg:
            assign[g] = choice
        decisions.append({
            "site": g,
            "assigned": cfg_spec_str(choice),
            "loss": current_loss,
            "trials": trials,
            "est_savings": savings[g],
        })

    return CalibrationResult(policy=policy_of(assign), base_loss=base_loss, budget=budget,
                             decisions=decisions)


# ---------------------------------------------------------------------------
# policy artifacts
# ---------------------------------------------------------------------------

ARTIFACT_FORMAT = "plam-numerics-policy/v1"


def save_policy_artifact(path: str, policy, report: Optional[dict] = None) -> None:
    """Write a reusable policy artifact (JSON) that ``--numerics-policy``
    of either package's launchers reads."""
    policy = as_policy(policy)
    data = {
        "format": ARTIFACT_FORMAT,
        "policy": policy_to_dict(policy),
        "policy_str": policy_to_str(policy),
        "report": report or {},
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def load_policy_artifact(path: str) -> NumericsPolicy:
    """Load a saved artifact through the CLI loader; a missing file is an
    error, not a policy-string fallback."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return load_policy_arg(path)


def top1_agreement(logits_a, logits_b) -> float:
    """Fraction of positions where two logit arrays (numpy or tensors)
    argmax-agree."""
    def arr(x):
        return x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) else x

    a = np.argmax(np.asarray(arr(logits_a), np.float32), axis=-1)
    b = np.argmax(np.asarray(arr(logits_b), np.float32), axis=-1)
    return float(np.mean(a == b))
