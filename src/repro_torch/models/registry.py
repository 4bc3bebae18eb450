"""Uniform model API over the architecture families (port of
``repro/models/registry.py``).

The dense and MoE families share the transformer's static and paged
entry points; the ssm (``mamba_lm.py``) and hybrid (``hybrid.py``)
families have a static path only, and their paged fields are None, as in
the reference.  encdec and vlm are still to be ported (``ROADMAP.md``,
queue 1, item 11), and training the MoE, ssm and hybrid families waits
for item 10a.

``prefill(model, batch)`` takes the family's prefill inputs (``{"tokens":
[B, S]}``), makes the caches the reference's does (bf16: KV caches of
the prompt's length, the SSM state) on the tokens' device, and returns
(logits [B, 1, V], caches); ``decode_step(model, batch)`` takes
``{"token": [B, 1], "cache_len": int}`` and the caches under the
family's key (``kv_caches`` or ``caches``).  ``prefill_inputs(batch,
seq_len)`` describes the prefill batch as meta tensors, the analogue of
the reference's ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig

from . import hybrid as _hybrid
from . import mamba_lm as _mamba
from . import transformer as _tf

CACHE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable  # (seed=0, device=None) -> model
    train_loss: Callable  # (model, batch, use_kernel=None) -> scalar f32 loss
    prefill: Callable  # (model, batch, use_kernel=None) -> (logits, caches)
    decode_step: Callable  # (model, batch with caches, use_kernel=None) -> (logits, caches)
    prefill_inputs: Callable  # (batch, seq_len) -> {name: meta tensor}
    # the paged KV-cache path (continuous batching); None for the families
    # without a paged layout (the ssm/hybrid state caches)
    paged_pool_init: Optional[Callable] = None  # (num_blocks, block_size, dtype, device)
    paged_prefill: Optional[Callable] = None  # (model, tokens, kp, vp, block_ids, true_len, uk)
    # (model, tokens, kp, vp, block_ids, cache_len, last_idx, use_kernel)
    paged_prefill_chunk: Optional[Callable] = None
    paged_decode_step: Optional[Callable] = None  # (model, token, kp, vp, tables, lengths, uk)
    # (model, tokens [B,W], kp, vp, tables, lengths, use_kernel)
    paged_score_tokens: Optional[Callable] = None


def _prefill_inputs(batch: int, seq_len: int):
    return {"tokens": torch.empty((batch, seq_len), dtype=torch.int32, device="meta")}


def _later_training(cfg: ModelConfig):
    def train_loss(model, batch, use_kernel=None):
        raise NotImplementedError(
            f"training a {cfg.family} model is not ported yet ({_tf.LATER_TRAINING})")
    return train_loss


def build(cfg: ModelConfig) -> ModelAPI:
    fam = cfg.family
    if fam in _tf.FAMILIES:
        return _build_transformer(cfg)
    if fam == "ssm":
        def init(seed: int = 0, device=None):
            return _mamba.mamba_lm_init(cfg, seed=seed, device=device)

        def prefill(model, batch, use_kernel=None):
            tokens = batch["tokens"]
            caches = _mamba.cache_init(cfg, tokens.shape[0], 0, CACHE_DTYPE, tokens.device)
            return _mamba.prefill(cfg, model, tokens, caches, use_kernel)

        def decode_step(model, batch, use_kernel=None):
            return _mamba.decode_step(cfg, model, batch["token"], batch["caches"],
                                      batch["cache_len"], use_kernel)
    elif fam == "hybrid":
        def init(seed: int = 0, device=None):
            return _hybrid.hybrid_init(cfg, seed=seed, device=device)

        def prefill(model, batch, use_kernel=None):
            tokens = batch["tokens"]
            caches = _hybrid.cache_init(cfg, tokens.shape[0], tokens.shape[1], CACHE_DTYPE,
                                        tokens.device)
            return _hybrid.prefill(cfg, model, tokens, caches, use_kernel)

        def decode_step(model, batch, use_kernel=None):
            return _hybrid.decode_step(cfg, model, batch["token"], batch["caches"],
                                       batch["cache_len"], use_kernel)
    else:
        raise NotImplementedError(f"family {fam!r} " + _tf.LATER_FAMILY)
    return ModelAPI(cfg=cfg, init=init, train_loss=_later_training(cfg), prefill=prefill,
                    decode_step=decode_step, prefill_inputs=_prefill_inputs)


def _build_transformer(cfg: ModelConfig) -> ModelAPI:
    def init(seed: int = 0, device=None):
        return _tf.lm_init(cfg, seed=seed, device=device)

    def train_loss(model, batch, use_kernel=None):
        return _tf.train_loss(cfg, model, batch, use_kernel)

    def prefill(model, batch, use_kernel=None):
        tokens = batch["tokens"]
        b, s = tokens.shape
        caches = _tf.kv_cache_init(cfg, b, s, CACHE_DTYPE, tokens.device)
        return _tf.prefill(cfg, model, tokens, caches, use_kernel)

    def decode_step(model, batch, use_kernel=None):
        return _tf.decode_step(cfg, model, batch["token"], batch["kv_caches"],
                               batch["cache_len"], use_kernel)

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

    return ModelAPI(cfg=cfg, init=init, train_loss=train_loss, prefill=prefill,
                    decode_step=decode_step, prefill_inputs=_prefill_inputs,
                    paged_pool_init=paged_pool_init,
                    paged_prefill=paged_prefill, paged_prefill_chunk=paged_prefill_chunk,
                    paged_decode_step=paged_decode_step,
                    paged_score_tokens=paged_score_tokens)
