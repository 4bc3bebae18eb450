"""Uniform model API over the architecture families (port of
``repro/models/registry.py``).

The dense and MoE families share the transformer's static and paged
entry points; the vlm family (the transformer with M-RoPE and a prefix
of patch embeddings), the ssm (``mamba_lm.py``), hybrid (``hybrid.py``)
and encdec (``encdec.py``) families have a static path only, and their
paged fields are None, as in the reference.  Every family trains:
``train_loss(model, batch)`` takes the batch that ``train_inputs``
describes and returns the mean next-token cross-entropy.

``prefill(model, batch)`` takes the family's prefill inputs (``{"tokens":
[B, S]}``; the vlm's adds ``"embeds_prefix"`` [B, P, d], the encdec's
``"frames"`` [B, S_src, frontend_dim]), makes the caches the
reference's does (bf16: KV caches of the prompt's length, P + S for the
vlm, the SSM state) on the tokens' device, and returns (logits [B, 1,
V], caches); ``decode_step(model, batch)`` takes ``{"token": [B, 1],
"cache_len": int}``, the caches under the family's key (``kv_caches`` or
``caches``) and, for encdec, the encoder output ``"enc_out"``.
``train_inputs(batch, seq_len)`` and ``prefill_inputs(batch, seq_len)``
describe the training and prefill batches as meta tensors, the analogue
of the reference's ``ShapeDtypeStruct``s (a vlm row's ``seq_len`` counts
its patches, an encdec row's its source frames); the stub frontends'
inputs are the caller's (seeded numpy arrays in the tests and the chip
smoke).  ``decode_inputs(batch, seq_len)`` describes one decode step
after ``seq_len`` cached positions: the token [B, 1], the family's caches
(bf16 K/V [L, B, S, kv, hd] for the transformer families; the ssm's and
hybrid's ``cache_init`` at (B, S); the encdec's decoder caches at its
target prefix, with ``enc_out`` [B, S, d]) and ``cache_len``, the cache's
last slot.  ``cache_len`` is a host int where the reference traces an
int32 scalar: the port's eager attention slices the cache with it
(``attention.py::attn_apply``), so a meta tensor could not stand in.
Together with ``init(seed, device="meta")`` these are the dry run's
cells (``launch/dryrun.py``), built without a byte of device memory.

Under tensor parallelism every family's hooks run on one rank's shard
(``parallel/sharding.py``): ``init(mesh=...)`` draws it,
``paged_pool_init(n_kv=...)`` allocates the rank's kv heads, and the
paged entry points take the shard as they take a whole model, their
collectives called inside the engine's mesh; the static entry points
make the rank's caches (its kv heads, or its SSD heads and channels)
inside the caller's mesh (``use_mesh``), and a hybrid decode batch with
``"seq_parallel": True`` holds this data rank's positions of the shared
K/V (``hybrid.py::seq_shard_caches``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig

from . import encdec as _encdec
from . import hybrid as _hybrid
from . import mamba_lm as _mamba
from . import transformer as _tf

CACHE_DTYPE = torch.bfloat16
VLM_PATCHES = 1024  # stub vision frontend: a 32 x 32 patch grid (16 when reduced)
ENCDEC_TGT_LEN = 4096  # the encdec's longest target prefix (64 when reduced)


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable  # (seed=0, device=None, mesh=None) -> model (a rank's shard under mesh)
    train_loss: Callable  # (model, batch, use_kernel=None) -> scalar f32 loss
    prefill: Callable  # (model, batch, use_kernel=None) -> (logits, caches)
    decode_step: Callable  # (model, batch with caches, use_kernel=None) -> (logits, caches)
    train_inputs: Callable  # (batch, seq_len) -> {name: meta tensor}
    prefill_inputs: Callable  # (batch, seq_len) -> {name: meta tensor}
    decode_inputs: Callable  # (batch, seq_len) -> {name: meta tensor, "cache_len": int}
    # the paged KV-cache path (continuous batching); None for the families
    # without a paged layout (the ssm/hybrid state caches)
    # (num_blocks, block_size, dtype, device, n_kv=None: a rank's kv heads)
    paged_pool_init: Optional[Callable] = None
    paged_prefill: Optional[Callable] = None  # (model, tokens, kp, vp, block_ids, true_len, uk)
    # (model, tokens, kp, vp, block_ids, cache_len, last_idx, use_kernel)
    paged_prefill_chunk: Optional[Callable] = None
    paged_decode_step: Optional[Callable] = None  # (model, token, kp, vp, tables, lengths, uk)
    # (model, tokens [B,W], kp, vp, tables, lengths, use_kernel)
    paged_score_tokens: Optional[Callable] = None


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _prefill_inputs(batch: int, seq_len: int):
    return {"tokens": _meta((batch, seq_len))}


def _labelled(inputs):
    """A family's training batch: its prefill inputs, and labels shaped as
    its tokens."""
    return {**inputs, "labels": _meta(inputs["tokens"].shape)}


def _train_inputs(batch: int, seq_len: int):
    return _labelled(_prefill_inputs(batch, seq_len))


def _decode_inputs(caches, cache_key: str, batch: int, cache_len: int, **extra):
    """One decode step's inputs: the token [B, 1], ``caches`` under
    ``cache_key``, ``cache_len`` (the host int the step writes at)."""
    return {"token": _meta((batch, 1)), cache_key: caches, **extra,
            "cache_len": cache_len}


def _rank_kv(cfg: ModelConfig) -> int:
    """The kv heads a cache holds: all of them, or inside a mesh a model
    rank's (``kv_heads_for_rank``)."""
    from repro_torch.parallel.sharding import current_mesh, kv_heads_for_rank

    mesh = current_mesh()
    return cfg.n_kv if mesh is None else len(kv_heads_for_rank(
        cfg.n_heads, cfg.n_kv, mesh.model_size, mesh.model_rank))


def _kv_caches(layers: int, batch: int, seq_len: int, cfg: ModelConfig):
    """Meta K/V caches [L, B, S, kv, hd] of :func:`_rank_kv`'s heads."""
    shape = (layers, batch, seq_len, _rank_kv(cfg), cfg.hd)
    return (_meta(shape, CACHE_DTYPE), _meta(shape, CACHE_DTYPE))


def vlm_patches(cfg: ModelConfig) -> int:
    """Patch embeddings ahead of a vlm prompt's tokens."""
    return VLM_PATCHES if cfg.d_model > 512 else 16


def encdec_tgt_len(cfg: ModelConfig, seq_len: int) -> int:
    """The encdec's target prefix for ``seq_len`` source frames."""
    return min(seq_len, ENCDEC_TGT_LEN if cfg.d_model > 512 else 64)


def build(cfg: ModelConfig) -> ModelAPI:
    fam = cfg.family
    if fam in _tf.FAMILIES:
        return _build_transformer(cfg)
    if fam == "encdec":
        return _build_encdec(cfg)
    if fam == "ssm":
        def init(seed: int = 0, device=None, mesh=None):
            return _mamba.mamba_lm_init(cfg, seed=seed, device=device, mesh=mesh)

        def train_loss(model, batch, use_kernel=None):
            return _mamba.train_loss(cfg, model, batch, use_kernel)

        def prefill(model, batch, use_kernel=None):
            tokens = batch["tokens"]
            caches = _mamba.cache_init(cfg, tokens.shape[0], 0, CACHE_DTYPE, tokens.device)
            return _mamba.prefill(cfg, model, tokens, caches, use_kernel)

        def decode_step(model, batch, use_kernel=None):
            return _mamba.decode_step(cfg, model, batch["token"], batch["caches"],
                                      batch["cache_len"], use_kernel)

        def decode_inputs(batch: int, seq_len: int):
            caches = _mamba.cache_init(cfg, batch, seq_len, CACHE_DTYPE, "meta")
            return _decode_inputs(caches, "caches", batch, seq_len - 1)
    elif fam == "hybrid":
        def init(seed: int = 0, device=None, mesh=None):
            return _hybrid.hybrid_init(cfg, seed=seed, device=device, mesh=mesh)

        def train_loss(model, batch, use_kernel=None):
            return _hybrid.train_loss(cfg, model, batch, use_kernel)

        def prefill(model, batch, use_kernel=None):
            tokens = batch["tokens"]
            caches = _hybrid.cache_init(cfg, tokens.shape[0], tokens.shape[1], CACHE_DTYPE,
                                        tokens.device)
            return _hybrid.prefill(cfg, model, tokens, caches, use_kernel)

        def decode_step(model, batch, use_kernel=None):
            return _hybrid.decode_step(cfg, model, batch["token"], batch["caches"],
                                       batch["cache_len"], use_kernel,
                                       batch.get("seq_parallel", False))

        def decode_inputs(batch: int, seq_len: int):
            caches = _hybrid.cache_init(cfg, batch, seq_len, CACHE_DTYPE, "meta")
            return _decode_inputs(caches, "caches", batch, seq_len - 1)
    else:
        raise ValueError(f"unknown family {fam!r}")
    return ModelAPI(cfg=cfg, init=init, train_loss=train_loss, prefill=prefill,
                    decode_step=decode_step, train_inputs=_train_inputs,
                    prefill_inputs=_prefill_inputs, decode_inputs=decode_inputs)


def _build_encdec(cfg: ModelConfig) -> ModelAPI:
    def init(seed: int = 0, device=None, mesh=None):
        return _encdec.encdec_init(cfg, seed=seed, device=device, mesh=mesh)

    def train_loss(model, batch, use_kernel=None):
        return _encdec.train_loss(cfg, model, batch, use_kernel)

    def prefill(model, batch, use_kernel=None):
        tokens = batch["tokens"]
        caches = _encdec.kv_cache_init(cfg, tokens.shape[0], tokens.shape[1], CACHE_DTYPE,
                                       tokens.device, _rank_kv(cfg))
        frames = torch.as_tensor(batch["frames"]).to(tokens.device)
        return _encdec.prefill(cfg, model, frames, tokens, caches, use_kernel)

    def decode_step(model, batch, use_kernel=None):
        return _encdec.decode_step(cfg, model, batch["token"], batch["enc_out"],
                                   batch["kv_caches"], batch["cache_len"], use_kernel)

    def prefill_inputs(batch: int, seq_len: int):
        act = _tf.torch_dtype(cfg.act_dtype)
        return {"frames": _meta((batch, seq_len, cfg.frontend_dim), act),
                "tokens": _meta((batch, encdec_tgt_len(cfg, seq_len)))}

    def train_inputs(batch: int, seq_len: int):
        return _labelled(prefill_inputs(batch, seq_len))

    def decode_inputs(batch: int, seq_len: int):
        t = encdec_tgt_len(cfg, seq_len)
        enc_out = _meta((batch, seq_len, cfg.d_model), _tf.torch_dtype(cfg.act_dtype))
        return _decode_inputs(_kv_caches(cfg.dec_layers, batch, t, cfg), "kv_caches", batch,
                              t - 1, enc_out=enc_out)

    return ModelAPI(cfg=cfg, init=init, train_loss=train_loss, prefill=prefill,
                    decode_step=decode_step, train_inputs=train_inputs,
                    prefill_inputs=prefill_inputs, decode_inputs=decode_inputs)


def _build_transformer(cfg: ModelConfig) -> ModelAPI:
    def init(seed: int = 0, device=None, mesh=None):
        return _tf.lm_init(cfg, seed=seed, device=device, mesh=mesh)

    def train_loss(model, batch, use_kernel=None):
        return _tf.train_loss(cfg, model, batch, use_kernel)

    def prefill(model, batch, use_kernel=None):
        tokens = batch["tokens"]
        b, s = tokens.shape
        if cfg.family == "vlm":
            return _vlm_prefill(cfg, model, tokens, batch["embeds_prefix"], use_kernel)
        caches = _tf.kv_cache_init(cfg, b, s, CACHE_DTYPE, tokens.device, _rank_kv(cfg))
        return _tf.prefill(cfg, model, tokens, caches, use_kernel)

    def decode_step(model, batch, use_kernel=None):
        return _tf.decode_step(cfg, model, batch["token"], batch["kv_caches"],
                               batch["cache_len"], use_kernel)

    def decode_inputs(batch: int, seq_len: int):
        return _decode_inputs(_kv_caches(cfg.n_layers, batch, seq_len, cfg), "kv_caches",
                              batch, seq_len - 1)

    if cfg.family == "vlm":
        def prefill_inputs(batch: int, seq_len: int):
            p = vlm_patches(cfg)
            return {"tokens": _meta((batch, seq_len - p)),
                    "embeds_prefix": _meta((batch, p, cfg.d_model),
                                           _tf.torch_dtype(cfg.act_dtype))}

        def train_inputs(batch: int, seq_len: int):
            return _labelled(prefill_inputs(batch, seq_len))

        return ModelAPI(cfg=cfg, init=init, train_loss=train_loss, prefill=prefill,
                        decode_step=decode_step, train_inputs=train_inputs,
                        prefill_inputs=prefill_inputs, decode_inputs=decode_inputs)

    def paged_pool_init(num_blocks, block_size, dtype, device, n_kv=None):
        return _tf.paged_kv_pool_init(cfg, num_blocks, block_size, dtype, device, n_kv)

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
                    decode_step=decode_step, train_inputs=_train_inputs,
                    prefill_inputs=_prefill_inputs, decode_inputs=decode_inputs,
                    paged_pool_init=paged_pool_init,
                    paged_prefill=paged_prefill, paged_prefill_chunk=paged_prefill_chunk,
                    paged_decode_step=paged_decode_step,
                    paged_score_tokens=paged_score_tokens)


@torch.no_grad()
def _vlm_prefill(cfg: ModelConfig, model, tokens, embeds_prefix, use_kernel):
    """The vlm's prefill (``transformer.py::prefill_prefix``) into caches of
    P + S positions, of the kv heads a rank holds inside a mesh.  Returns
    (logits [B, 1, V] at the last token, kv_caches)."""
    b, s = tokens.shape
    caches = _tf.kv_cache_init(cfg, b, embeds_prefix.shape[1] + s, CACHE_DTYPE, tokens.device,
                               _rank_kv(cfg))
    return _tf.prefill_prefix(cfg, model, tokens, embeds_prefix, caches, use_kernel)
