"""Uniform model API over the architecture families (port of the ``dense``
and ``moe`` branches of ``repro/models/registry.py``, which share the
transformer's paged entry points; the other families are still to be
ported, ``ROADMAP.md`` queue 1, item 11)."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig

from . import transformer as _tf


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable  # (seed=0, device=None) -> model
    train_loss: Callable  # (model, batch, use_kernel=None) -> scalar f32 loss
    paged_pool_init: Callable  # (num_blocks, block_size, dtype, device) -> pools
    paged_prefill: Callable  # (model, tokens, kp, vp, block_ids, true_len, use_kernel)
    # (model, tokens, kp, vp, block_ids, cache_len, last_idx, use_kernel)
    paged_prefill_chunk: Callable
    paged_decode_step: Callable  # (model, token, kp, vp, tables, lengths, use_kernel)
    paged_score_tokens: Callable  # (model, tokens [B,W], kp, vp, tables, lengths, use_kernel)


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _tf.FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} " + _tf.LATER_FAMILY)

    def init(seed: int = 0, device=None):
        return _tf.lm_init(cfg, seed=seed, device=device)

    def train_loss(model, batch, use_kernel=None):
        return _tf.train_loss(cfg, model, batch, use_kernel)

    def paged_pool_init(num_blocks, block_size, dtype, device):
        return _tf.paged_kv_pool_init(cfg, num_blocks, block_size, dtype, device)

    def paged_prefill(model, tokens, k_pool, v_pool, block_ids, true_len,
                      use_kernel=None):
        return _tf.paged_prefill(cfg, model, tokens, k_pool, v_pool, block_ids,
                                 true_len, use_kernel)

    def paged_prefill_chunk(model, tokens, k_pool, v_pool, block_ids, cache_len,
                            last_idx, use_kernel=None):
        return _tf.paged_prefill_chunk(cfg, model, tokens, k_pool, v_pool, block_ids,
                                       cache_len, last_idx, use_kernel)

    def paged_decode_step(model, token, k_pool, v_pool, block_tables, lengths,
                          use_kernel=None):
        return _tf.paged_decode_step(cfg, model, token, k_pool, v_pool, block_tables,
                                     lengths, use_kernel)

    def paged_score_tokens(model, tokens, k_pool, v_pool, block_tables, lengths,
                           use_kernel=None):
        return _tf.paged_score_tokens(cfg, model, tokens, k_pool, v_pool, block_tables,
                                      lengths, use_kernel)

    return ModelAPI(cfg=cfg, init=init, train_loss=train_loss,
                    paged_pool_init=paged_pool_init,
                    paged_prefill=paged_prefill, paged_prefill_chunk=paged_prefill_chunk,
                    paged_decode_step=paged_decode_step,
                    paged_score_tokens=paged_score_tokens)
