"""Per-site MAC counts (port of ``repro/numerics/calibrate.py::site_macs``).

Only :func:`site_macs` is here so far: the serving metrics registry
attributes forward-pass MACs to each resolved numerics mode through it
(``serving/observability.py::macs_per_token_by_mode``).  The rest of the
reference module, the greedy mixed-numerics policy search and its
multiplier-cost model, comes with training and the paper's tables
(``ROADMAP.md``, queue 1, item 10).
"""
from __future__ import annotations

from typing import Dict


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
