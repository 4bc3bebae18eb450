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
in the request's own context).  The reference's ``DraftModelDrafter``
drafts through the static ``Engine``, which is not ported yet, so
``make_drafter("model:<arch>")`` raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Protocol, runtime_checkable

from repro_torch.configs.base import ModelConfig

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

    def propose(self, req: Request, k: int) -> List[int]:
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


def make_drafter(spec: str, target_cfg: ModelConfig) -> Drafter:
    """Resolve a ``spec_draft`` string to a drafter.

    ``"ngram"`` / ``"ngram:N"``: self-speculative lookup (max width N,
    default 3).  ``"model:<arch>"`` needs the static engine and raises
    ``NotImplementedError`` until it is ported; ``target_cfg`` is the
    model whose vocabulary a draft model would have to share.
    """
    if spec == "ngram" or spec.startswith("ngram:"):
        max_n = int(spec.split(":", 1)[1]) if ":" in spec else 3
        return NgramDrafter(max_n=max_n)
    if spec.startswith("model:"):
        raise NotImplementedError(
            f"spec_draft={spec!r}: a draft model runs on the static engine, which is "
            "not ported yet (ROADMAP.md, queue 1: static engine)")
    raise ValueError(
        f"unknown drafter spec {spec!r}; use 'ngram', 'ngram:N' or 'model:<arch>'")
