"""Drafters for speculative decoding.

Port of ``repro/serving/spec.py``.  A drafter proposes ``k``
continuation tokens for a running request; the engine scores all
``k + 1`` positions (the last committed token and the drafts) in one
batched verify step (``repro_torch.models.transformer.paged_score_tokens``)
and commits the longest prefix the target model agrees with, plus the
target's own correction or bonus token.  Under greedy sampling the
committed stream is the one plain one-token decode gives: a drafter
changes how fast tokens come out, never which.

:class:`NgramDrafter` is the built-in drafter (self-speculative lookup
in the request's own context).  :class:`DraftModelDrafter` drafts with
a small model sharing the target's vocabulary, run greedily through the
static :class:`~repro_torch.serving.engine.Engine`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, runtime_checkable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike

from .scheduler import Request


@runtime_checkable
class Drafter(Protocol):
    """Anything with ``propose(request, k) -> k token ids``.

    Preemption contract: a request may be evicted and resumed later with
    its committed context (prompt + output) intact, so a drafter that
    reads only ``req.prompt + req.output`` is preemption-safe.  A
    drafter that keeps per-request state may expose ``on_preempt(req)``;
    the engine calls it when ``req`` is evicted.
    """

    def propose(self, req: Request, k: int) -> List[int]:
        """Return exactly k drafted continuation tokens for ``req``."""
        ...  # pragma: no cover


def _pad_drafts(drafts: List[int], k: int, fallback: int) -> List[int]:
    """Right-pad a (possibly short) draft list to exactly k tokens."""
    out = list(drafts[:k])
    while len(out) < k:
        out.append(out[-1] if out else fallback)
    return out


class NgramDrafter:
    """Self-speculative n-gram lookup over the request's own context.

    For n from ``max_n`` down to ``min_n``: take the last n committed
    tokens as the probe, find its most recent earlier occurrence in the
    context, and propose the k tokens that followed it.  Falls back to
    repeating the last token when nothing matches.
    """

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got {min_n}, {max_n}")
        self.max_n = max_n
        self.min_n = min_n
        # read live by the engine's metrics registry
        self.proposals = 0
        self.proposed_tokens = 0

    def propose(self, req: Request, k: int) -> List[int]:
        self.proposals += 1
        self.proposed_tokens += k
        ctx = req.prompt + req.output
        fallback = ctx[-1] if ctx else 0
        for n in range(self.max_n, self.min_n - 1, -1):
            if len(ctx) <= n:
                continue
            probe = ctx[len(ctx) - n:]
            # the most recent earlier occurrence wins
            for start in range(len(ctx) - n - 1, -1, -1):
                if ctx[start:start + n] == probe:
                    cont = ctx[start + n:start + n + k]
                    if cont:
                        return _pad_drafts(cont, k, fallback)
        return [fallback] * k


class DraftModelDrafter:
    """Draft with a small model sharing the target's vocabulary.

    Each proposal greedily decodes k tokens through the static
    :class:`~repro_torch.serving.engine.Engine`, conditioned on a
    power-of-two suffix window of the committed context (at most
    ``window`` tokens), as the reference's drafter does (there the window
    bounds XLA compiles; here it keeps the draft's inputs the same).  The
    draft model's weights are its own: ``params`` (e.g. carried across
    with ``repro_torch.convert.params_from_jax``), or else the port's
    seeded init (``init_seed``) on ``device``.  Only the token space is
    shared, so the vocabularies must be equal.
    """

    def __init__(self, draft_cfg: ModelConfig, target_cfg: ModelConfig,
                 params: Optional[torch.nn.Module] = None, init_seed: int = 0,
                 window: int = 32, device: DeviceLike = None,
                 use_kernel: Optional[bool] = None):
        if draft_cfg.vocab != target_cfg.vocab:
            raise ValueError(
                f"draft model vocab {draft_cfg.vocab} != target vocab {target_cfg.vocab}; "
                "speculative decoding requires a shared tokenizer")
        if window < 1:
            raise ValueError(f"window must be at least 1, got {window}")
        from .engine import Engine, ServeConfig  # local: the engine imports this module

        self.window = window
        self._engine = Engine(draft_cfg, params=params, init_seed=init_seed, device=device,
                              use_kernel=use_kernel)
        self._scfg_cls = ServeConfig
        # read live by the engine's metrics registry
        self.proposals = 0
        self.proposed_tokens = 0

    def propose(self, req: Request, k: int) -> List[int]:
        self.proposals += 1
        self.proposed_tokens += k
        ctx = req.prompt + req.output
        w = 1
        while w * 2 <= min(len(ctx), self.window):
            w *= 2
        tokens = torch.tensor([ctx[len(ctx) - w:]], dtype=torch.int32)
        out = self._engine.generate({"tokens": tokens}, self._scfg_cls(max_new_tokens=k))
        return _pad_drafts(out[0].tolist(), k, ctx[-1])


def make_drafter(spec: str, target_cfg: ModelConfig, init_seed: int = 0,
                 device: DeviceLike = None, use_kernel: Optional[bool] = None) -> Drafter:
    """Resolve a ``spec_draft`` string to a drafter.

    ``"ngram"`` / ``"ngram:N"``: self-speculative lookup (max width N,
    default 3).  ``"model:<arch>"``: the architecture ``arch`` (reduced,
    f32, from the seeded init ``init_seed`` on ``device``) as a draft
    model; it must share ``target_cfg``'s vocabulary.
    """
    if spec == "ngram" or spec.startswith("ngram:"):
        max_n = int(spec.split(":", 1)[1]) if ":" in spec else 3
        return NgramDrafter(max_n=max_n)
    if spec.startswith("model:"):
        from repro_torch.configs import ARCHS, get_config

        arch = spec.split(":", 1)[1]
        if arch not in ARCHS:
            raise ValueError(f"unknown draft arch {arch!r}; pick from {sorted(ARCHS)}")
        draft_cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype="float32",
                                        act_dtype="float32")
        return DraftModelDrafter(draft_cfg, target_cfg, init_seed=init_seed, device=device,
                                 use_kernel=use_kernel)
    raise ValueError(
        f"unknown drafter spec {spec!r}; use 'ngram', 'ngram:N' or 'model:<arch>'")
