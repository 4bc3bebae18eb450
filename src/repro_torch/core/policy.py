"""Per-site mixed-numerics policy: which multiplier runs at which matmul.

A copy of ``repro/core/policy.py`` (JAX-free logic), kept in the port so
the port imports nothing of the JAX package.

Sensitivity to approximate multiplication is not uniform across a
network — Deep Positron and Fixed-Posit both show the right posit /
fixed format differs per layer and per tensor role.  A
:class:`NumericsPolicy` maps a matmul *site* (a dotted role tag plus an
optional layer index) to a per-site :class:`NumericsConfig`, so one
model can run PLAM MLPs, exact-posit attention and an f32 router at the
same time.

Role taxonomy (see docs/numerics.md for the full table)::

    attn.qkv   attn.out          self-attention projections
    attn.cross.qkv  attn.cross.out   enc-dec cross-attention
    mlp.up  mlp.gate  mlp.down   dense FFN
    moe.router                    MoE gate (f32 baseline rule)
    moe.expert.{up,gate,down}     routed expert FFNs
    moe.shared.{up,gate,down}     DeepSeek-style shared experts
    ssm.proj.in  ssm.proj.out     Mamba2 projections
    lm_head  frontend  hybrid.proj

Policy strings are comma-separated ``selector=cfg`` items::

    default=plam_sim:16:1, moe.router=f32, layers[0,-1]=posit_quant

* ``selector`` is ``default`` (every site), a role or role group
  (``attn`` matches ``attn.qkv`` and ``attn.out``), ``layers[SPEC]``
  (every role at the selected layers), or ``role@layers[SPEC]``.
  ``SPEC`` is a comma list of indices and python-style ``a:b`` ranges;
  negative indices count from the end.
* ``cfg`` is ``mode[:n[:es]]`` — e.g. ``plam_sim:16:1``, ``f32``.

Resolution: among matching rules the most *role-specific* wins
(exact role > role group > layers-only > default); a layer selector
breaks ties at equal role depth; later rules win exact ties.  The
legacy hard-coded "router stays exact f32" escape hatch survives as an
implicit ``moe.router=f32`` rule that any explicit ``moe.router=...``
overrides.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import List, Optional, Tuple, Union

from .modes import MODES, NumericsConfig

__all__ = [
    "NumericsPolicy",
    "Rule",
    "BoundPolicy",
    "as_policy",
    "bind",
    "cfg_spec_str",
    "describe",
    "layer_segments",
    "load_policy_arg",
    "parse_cfg_spec",
    "parse_policy",
    "parse_policy_str",
    "policy_from_dict",
    "policy_to_dict",
    "policy_to_str",
    "site",
    "site_for",
]

# A layer-selector item: ("idx", i, None) or ("range", start, stop) with
# python range semantics; start/stop may be None (open end) and
# negative indices count from n_layers.
LayerItem = Tuple[str, Optional[int], Optional[int]]

_CFG_FIELDS = {f.name for f in dataclasses.fields(NumericsConfig)}


def _norm(i: int, n_layers: int) -> int:
    return i + n_layers if i < 0 else i


def _item_matches(item: LayerItem, layer: int, n_layers: int) -> bool:
    kind, a, b = item
    if kind == "idx":
        return layer == _norm(a, n_layers)
    lo = 0 if a is None else _norm(a, n_layers)
    hi = n_layers if b is None else _norm(b, n_layers)
    return lo <= layer < hi


@dataclasses.dataclass(frozen=True)
class Rule:
    """One policy entry: (role pattern, layer selector) -> config.

    ``role == ""`` matches every role; otherwise the rule matches the
    exact role and every dotted descendant (``"mlp"`` covers
    ``"mlp.up"``).  ``layers is None`` matches every layer, including
    sites with no layer index at all; a concrete selector only matches
    when the call site knows its layer.
    """

    role: str = ""
    layers: Optional[Tuple[LayerItem, ...]] = None
    cfg: NumericsConfig = NumericsConfig()

    def matches(
        self, role: str, layer: Optional[int], n_layers: Optional[int]
    ) -> bool:
        if self.role and role != self.role and not role.startswith(self.role + "."):
            return False
        if self.layers is not None:
            if layer is None or n_layers is None:
                return False
            if not any(_item_matches(it, layer, n_layers) for it in self.layers):
                return False
        return True

    @property
    def role_depth(self) -> int:
        return 0 if not self.role else self.role.count(".") + 1


# The pre-refactor code hard-wired an exact-f32 router inside moe.py
# (routing is control flow).  That escape hatch survives as the lowest-
# priority *exact* rule: any explicit ``moe.router=...`` overrides it,
# but a bare ``default=plam_sim`` does not silently approximate routing.
_ROUTER_BASELINE = Rule(role="moe.router", cfg=NumericsConfig(mode="f32"))


@dataclasses.dataclass(frozen=True)
class NumericsPolicy:
    """An ordered rule list resolving matmul sites to NumericsConfigs."""

    rules: Tuple[Rule, ...] = ()

    @staticmethod
    def uniform(cfg: NumericsConfig) -> "NumericsPolicy":
        return NumericsPolicy(rules=(Rule(cfg=cfg),))

    def resolve(
        self,
        role: str,
        layer: Optional[int] = None,
        n_layers: Optional[int] = None,
    ) -> NumericsConfig:
        """Most-specific matching rule's config for one site.

        Precedence key: (role depth, has-layer-selector, rule order) —
        maximal wins.  The implicit router baseline sits at order -1 so
        explicit rules of equal specificity beat it.
        """
        best: Optional[NumericsConfig] = None
        best_key = None
        for i, rule in enumerate((_ROUTER_BASELINE, *self.rules)):
            if not rule.matches(role, layer, n_layers):
                continue
            key = (rule.role_depth, 0 if rule.layers is None else 1, i)
            if best_key is None or key >= best_key:
                best, best_key = rule.cfg, key
        if best is None:
            raise KeyError(
                f"numerics policy has no rule for site {role!r}; "
                "add a 'default=<mode>' rule"
            )
        return best

    def has_layer_rules(self) -> bool:
        return any(r.layers is not None for r in self.rules)


@dataclasses.dataclass(frozen=True)
class BoundPolicy:
    """A policy fixed to one layer context; what model blocks receive."""

    policy: NumericsPolicy
    layer: Optional[int] = None
    n_layers: Optional[int] = None

    def site(self, role: str) -> NumericsConfig:
        return self.policy.resolve(role, self.layer, self.n_layers)


# Uniform legacy configs keep the router baseline too, so a plain
# ``NumericsConfig(mode="plam_sim")`` stays bit-identical to the
# pre-policy code (which special-cased the router inline).
_UNIFORM_BASELINE = {"moe.router": NumericsConfig(mode="f32")}

SiteNumerics = Union[NumericsConfig, BoundPolicy]


def site(nc: SiteNumerics, role: str) -> NumericsConfig:
    """Resolve the config for one matmul site.

    ``nc`` is whatever flowed down from ``ModelConfig.numerics``: a
    plain :class:`NumericsConfig` (uniform numerics, the legacy path)
    or a :class:`BoundPolicy` produced by :func:`bind`.
    """
    if isinstance(nc, NumericsConfig):
        return _UNIFORM_BASELINE.get(role, nc)
    return nc.site(role)


def bind(
    numerics,
    layer: Optional[int] = None,
    n_layers: Optional[int] = None,
) -> SiteNumerics:
    """Fix a config-or-policy to a layer context for use with site()."""
    if isinstance(numerics, NumericsConfig):
        return numerics
    return BoundPolicy(as_policy(numerics), layer, n_layers)


def site_for(
    numerics,
    role: str,
    layer: Optional[int] = None,
    n_layers: Optional[int] = None,
) -> NumericsConfig:
    """One-shot ``site(bind(numerics, ...), role)``."""
    return site(bind(numerics, layer, n_layers), role)


def layer_segments(
    numerics,
    n_layers: int,
    start: int = 0,
    size: Optional[int] = None,
) -> List[Tuple[int, int, SiteNumerics]]:
    """Split a scanned layer stack into policy-uniform segments.

    Layer-range rules make the per-site config a function of the layer
    index, which a single ``lax.scan`` cannot express (every scanned
    layer shares one trace).  This helper splits the absolute layer
    range ``[start, start + size)`` into maximal runs matching the same
    rule subset; each run scans with one bound policy.  Uniform
    policies return a single segment — the exact pre-refactor scan.

    Returns ``[(rel_start, run_len, bound_numerics)]`` with
    ``rel_start`` relative to the sliced stack.
    """
    size = n_layers if size is None else size
    if isinstance(numerics, NumericsConfig):
        return [(0, size, numerics)]
    policy = as_policy(numerics)
    layered = [r for r in policy.rules if r.layers is not None]
    if not layered:
        return [(0, size, BoundPolicy(policy, None, n_layers))]

    def signature(layer: int):
        return tuple(
            any(_item_matches(it, layer, n_layers) for it in r.layers)
            for r in layered
        )

    segments: List[Tuple[int, int, SiteNumerics]] = []
    seg_start = 0
    seg_sig = signature(start)
    for rel in range(1, size):
        sig = signature(start + rel)
        if sig != seg_sig:
            bound = BoundPolicy(policy, start + seg_start, n_layers)
            segments.append((seg_start, rel - seg_start, bound))
            seg_start, seg_sig = rel, sig
    bound = BoundPolicy(policy, start + seg_start, n_layers)
    segments.append((seg_start, size - seg_start, bound))
    return segments


# ---------------------------------------------------------------------------
# parsing / serialization
# ---------------------------------------------------------------------------


def _parse_layer_spec(spec: str) -> Tuple[LayerItem, ...]:
    """``"0,-1,2:4,:3"`` -> layer items."""
    items: List[LayerItem] = []
    for raw in spec.split(","):
        tok = raw.strip()
        if not tok:
            raise ValueError(f"empty layer item in layers[{spec}]")
        if ":" in tok:
            a_s, b_s = tok.split(":", 1)
            a = int(a_s) if a_s.strip() else None
            b = int(b_s) if b_s.strip() else None
            items.append(("range", a, b))
        else:
            items.append(("idx", int(tok), None))
    return tuple(items)


def _layer_spec_str(items: Tuple[LayerItem, ...]) -> str:
    parts = []
    for kind, a, b in items:
        if kind == "idx":
            parts.append(str(a))
        else:
            parts.append(f"{'' if a is None else a}:{'' if b is None else b}")
    return ",".join(parts)


_LAYERS_RE = re.compile(r"^layers\[(?P<spec>[^\]]*)\]$")


def _parse_selector(sel: str) -> Tuple[str, Optional[Tuple[LayerItem, ...]]]:
    sel = sel.strip()
    role, layers_part = sel, None
    if "@" in sel:
        role, layers_part = (p.strip() for p in sel.split("@", 1))
    elif sel.startswith("layers["):
        role, layers_part = "", sel
    if role == "default":
        role = ""
    layers = None
    if layers_part is not None:
        m = _LAYERS_RE.match(layers_part)
        if not m:
            raise ValueError(f"bad layer selector in {sel!r}")
        layers = _parse_layer_spec(m.group("spec"))
    if role and not re.fullmatch(r"[A-Za-z_][\w.]*", role):
        raise ValueError(f"bad role {role!r} in selector {sel!r}")
    return role, layers


def _selector_str(role: str, layers: Optional[Tuple[LayerItem, ...]]) -> str:
    if layers is None:
        return role or "default"
    spec = f"layers[{_layer_spec_str(layers)}]"
    return f"{role}@{spec}" if role else spec


def parse_cfg_spec(spec) -> NumericsConfig:
    """``"plam_sim:16:1"`` / ``"f32"`` / field dict -> NumericsConfig."""
    if isinstance(spec, NumericsConfig):
        return spec
    if isinstance(spec, dict):
        unknown = set(spec) - _CFG_FIELDS
        if unknown:
            raise ValueError(f"unknown NumericsConfig fields {sorted(unknown)}")
        return NumericsConfig(**spec)
    parts = [p.strip() for p in str(spec).split(":")]
    if parts[0] not in MODES:
        raise ValueError(f"unknown numerics mode {parts[0]!r}; pick from {MODES}")
    kw = {"mode": parts[0]}
    if len(parts) > 1 and parts[1]:
        kw["n"] = int(parts[1])
    if len(parts) > 2 and parts[2]:
        kw["es"] = int(parts[2])
    if len(parts) > 3:
        raise ValueError(f"bad numerics spec {spec!r} (want mode[:n[:es]])")
    return NumericsConfig(**kw)


def cfg_spec_str(cfg: NumericsConfig) -> str:
    """Compact mode[:n[:es]] form of one config (inverse of parse_cfg_spec)."""
    if cfg.mode in ("f32", "bf16", "mitchell_f32"):
        return cfg.mode
    return f"{cfg.mode}:{cfg.n}:{cfg.es}"


def _split_top_level(s: str) -> List[str]:
    """Split on commas that are not inside ``layers[...]`` brackets."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return [p for p in (p.strip() for p in out) if p]


def parse_policy_str(s: str) -> NumericsPolicy:
    """Parse the compact comma syntax; a bare mode spec means uniform."""
    s = s.strip()
    if "=" not in s:
        return NumericsPolicy.uniform(parse_cfg_spec(s))
    rules = []
    for item in _split_top_level(s):
        if "=" not in item:
            raise ValueError(f"policy item {item!r} is not selector=cfg")
        sel, spec = (p.strip() for p in item.split("=", 1))
        role, layers = _parse_selector(sel)
        rules.append(Rule(role=role, layers=layers, cfg=parse_cfg_spec(spec)))
    return NumericsPolicy(rules=tuple(rules))


def parse_policy(x) -> NumericsPolicy:
    """Coerce str / dict / NumericsConfig / NumericsPolicy to a policy."""
    if isinstance(x, NumericsPolicy):
        return x
    if isinstance(x, NumericsConfig):
        return NumericsPolicy.uniform(x)
    if isinstance(x, dict):
        return policy_from_dict(x)
    if isinstance(x, str):
        return parse_policy_str(x)
    raise TypeError(f"cannot build a NumericsPolicy from {type(x).__name__}")


def as_policy(x) -> NumericsPolicy:
    return parse_policy(x)


def policy_to_dict(policy) -> dict:
    """Lossless JSON-safe form: {selector: NumericsConfig fields}.

    Selector strings keep rule order (dicts preserve insertion order),
    and configs serialize field-complete so carrier / quantize_acts /
    prequantized_weights survive checkpoint metadata round trips.
    """
    policy = as_policy(policy)
    out = {}
    for rule in policy.rules:
        out[_selector_str(rule.role, rule.layers)] = dataclasses.asdict(rule.cfg)
    return out


def policy_from_dict(d: dict) -> NumericsPolicy:
    rules = []
    for sel, spec in d.items():
        role, layers = _parse_selector(str(sel))
        rules.append(Rule(role=role, layers=layers, cfg=parse_cfg_spec(spec)))
    return NumericsPolicy(rules=tuple(rules))


def policy_to_str(policy) -> str:
    """Compact round-trippable string (drops non-mode/n/es fields)."""
    policy = as_policy(policy)
    return ", ".join(
        f"{_selector_str(r.role, r.layers)}={cfg_spec_str(r.cfg)}"
        for r in policy.rules
    )


def describe(numerics) -> str:
    """Short human/report label for a config or policy."""
    if isinstance(numerics, NumericsConfig):
        return numerics.mode
    return policy_to_str(numerics)


def load_policy_arg(arg: str) -> NumericsPolicy:
    """CLI helper: ``arg`` is a policy string or a path to a saved
    policy artifact (the JSON written by numerics/calibrate.py, or any
    JSON dict in ``policy_to_dict`` form).  A path-shaped argument
    (.json suffix or a path separator) that does not exist is an error
    — not a policy string — so typo'd artifact paths fail clearly."""
    if os.path.exists(arg):
        with open(arg) as f:
            data = json.load(f)
        if isinstance(data, dict) and "policy" in data:
            data = data["policy"]
        return policy_from_dict(data)
    if arg.endswith(".json") or os.sep in arg:
        raise FileNotFoundError(f"numerics policy artifact not found: {arg!r}")
    return parse_policy_str(arg)
