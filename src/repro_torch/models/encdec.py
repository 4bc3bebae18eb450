"""Encoder-decoder transformer, the seamless-m4t-medium backbone (port of
``repro/models/encdec.py``).

The audio frontend is a stub, as in the reference: the inputs are
precomputed frame embeddings [B, S_src, frontend_dim], projected to
d_model (site ``frontend``).  The encoder is bidirectional; each decoder
block runs causal self-attention over its KV cache, then
cross-attention over the encoder output (sites ``attn.cross.*``), then
its MLP.  Every block resolves its sites layer-free, as the reference's
``bind(cfg.numerics)``: layer-range policy rules target a decoder-only
LM's depth.

Like the reference, each decoder block computes its cross-attention K/V
from the encoder output on every call, decode steps included, and the
caller (the static engine) keeps the encoder output.

Under tensor parallelism (``parallel/sharding.py``) a rank holds its
shard (``encdec_init(mesh=...)``, drawn whole and cut): each block's
attention, cross-attention and MLP column- and row-parallel, the kv heads
of ``kv_heads_for_rank``, ``embed`` and ``unembed`` by vocabulary where
it divides tp (looked up and gathered as the transformer's),
``frontend_proj`` whole.  The caches hold the rank's kv heads, and the
encoder output enters the decoder's cross ``wk``/``wv`` through one
``copy_model``, so that its gradient is summed over ``model`` once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dense import dense, dense_init
from repro_torch.core.policy import bind, site_for
from repro_torch.parallel.sharding import copy_model, gather_model, shard_model

from .attention import Attention, attn_apply, cross_attn_apply, encode_cross_kv
from .common import RMSNorm, rmsnorm
from .mamba_lm import embed_init
from .mlp import MLP, mlp_apply
from .transformer import embed_tokens, lm_loss_chunked, torch_dtype


class EncBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``; a decoder block adds ``ln_x``
    and the cross-attention ``xattn``."""

    def __init__(self, cfg: ModelConfig, *, cross: bool, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, **kw)
        self.ln2 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.glu, **kw)
        if cross:
            self.ln_x = RMSNorm(cfg.d_model, device=device, dtype=dtype)
            self.xattn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, **kw)


class EncDecLM(nn.Module):
    """``frontend_proj`` [frontend_dim, d], ``embed`` [V, d],
    ``enc_layers``, ``dec_layers``, ``ln_enc``, ``ln_dec`` and ``unembed``
    [d, V], in the reference's layout.  ``vocab_parallel`` and
    ``tp_shard``: as ``transformer.DenseLM``'s."""

    vocab_parallel = False
    tp_shard = None

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        dtype = torch_dtype(cfg.param_dtype)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.frontend_proj = nn.Parameter(dense_init(cfg.frontend_dim, cfg.d_model, **kw),
                                          requires_grad=False)
        self.embed = nn.Parameter(embed_init(cfg.vocab, cfg.d_model, **kw),
                                  requires_grad=False)
        self.enc_layers = nn.ModuleList(EncBlock(cfg, cross=False, **kw)
                                        for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(EncBlock(cfg, cross=True, **kw)
                                        for _ in range(cfg.dec_layers))
        self.ln_enc = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.ln_dec = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.unembed = nn.Parameter(dense_init(cfg.d_model, cfg.vocab, **kw),
                                    requires_grad=False)
        for p in self.parameters():
            p.requires_grad_(False)


def encdec_init(cfg: ModelConfig, *, seed: int = 0, device=None, mesh=None) -> EncDecLM:
    """The port's own seeded init on ``device`` (CUDA by default; on
    ``"meta"`` shapes and dtypes only, ``device.init_generator``); under a
    ``mesh``, drawn whole and cut to this rank's shard
    (``parallel/sharding.py::shard_model``)."""
    from repro_torch.device import init_generator, resolve_device

    device = resolve_device(device)
    gen = init_generator(device, seed)
    return shard_model(EncDecLM(cfg, generator=gen, device=device), cfg, mesh)


def _positions(b: int, s: int, offset: int, device):
    return (torch.arange(s, dtype=torch.int32, device=device)[None, :] + offset).expand(b, s)


def encode(cfg: ModelConfig, model: EncDecLM, frames, use_kernel: Optional[bool] = None):
    """frames: [B, S_src, frontend_dim] precomputed frame embeddings.
    Returns the encoder output [B, S_src, d] after its final norm (under
    autograd in training; ``prefill`` and the engine call it without)."""
    nsite = bind(cfg.numerics)
    x = dense(frames.to(torch_dtype(cfg.act_dtype)), model.frontend_proj,
              site_for(cfg.numerics, "frontend"), use_kernel=use_kernel)
    b, s, _ = x.shape
    positions = _positions(b, s, 0, x.device)
    for blk in model.enc_layers:
        h, _ = attn_apply(blk.attn, rmsnorm(blk.ln1, x), nsite, n_heads=cfg.n_heads,
                          n_kv=cfg.n_kv, head_dim=cfg.hd, positions=positions,
                          rope_theta=cfg.rope_theta, mask="full", use_kernel=use_kernel)
        x = x + h
        x = x + mlp_apply(blk.mlp, rmsnorm(blk.ln2, x), nsite, cfg.act, use_kernel=use_kernel)
    return rmsnorm(model.ln_enc, x)


def _decoder(cfg: ModelConfig, model: EncDecLM, y, positions, enc_out, kv_caches=None,
             cache_len: Optional[int] = None, use_kernel: Optional[bool] = None):
    """The decoder blocks over the target embeddings ``y`` [B, S, d]; the
    caches (k, v [L_dec, B, S_max, kv, hd]) are written in place at
    ``cache_len``.  Returns (hidden after ``ln_dec``, kv_caches)."""
    nsite = bind(cfg.numerics)
    heads = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd)
    if model.dec_layers and model.dec_layers[0].xattn.row_parallel:
        enc_out = copy_model(enc_out)  # every layer's cut cross wk/wv reads it
    x = y
    for i, blk in enumerate(model.dec_layers):
        kv_slice = None if kv_caches is None else (kv_caches[0][i], kv_caches[1][i])
        h, _ = attn_apply(blk.attn, rmsnorm(blk.ln1, x), nsite, positions=positions,
                          rope_theta=cfg.rope_theta, kv_cache=kv_slice, cache_len=cache_len,
                          mask="causal", use_kernel=use_kernel, **heads)
        x = x + h
        enc_kv = encode_cross_kv(blk.xattn, enc_out, nsite, n_kv=cfg.n_kv, head_dim=cfg.hd,
                                 use_kernel=use_kernel)
        x = x + cross_attn_apply(blk.xattn, rmsnorm(blk.ln_x, x), enc_kv, nsite,
                                 use_kernel=use_kernel, **heads)
        x = x + mlp_apply(blk.mlp, rmsnorm(blk.ln2, x), nsite, cfg.act, use_kernel=use_kernel)
    return rmsnorm(model.ln_dec, x), kv_caches


def train_loss(cfg: ModelConfig, model: EncDecLM, batch, use_kernel: Optional[bool] = None):
    """batch: frames [B, S_src, frontend_dim], tokens and labels [B, S_tgt].
    The encoder's output feeds every decoder block's cross-attention; the
    loss is the chunked cross-entropy over the untied ``unembed``, as the
    reference's dense-LM view of the config (``tie_embeddings=False``)."""
    dev = model.embed.device
    frames = torch.as_tensor(batch["frames"]).to(dev)
    tokens = torch.as_tensor(batch["tokens"]).to(dev)
    enc_out = encode(cfg, model, frames, use_kernel)
    b, s = tokens.shape
    hidden, _ = _decoder(cfg, model, embed_tokens(cfg, model, tokens),
                         _positions(b, s, 0, dev), enc_out, use_kernel=use_kernel)
    return lm_loss_chunked(dataclasses.replace(cfg, tie_embeddings=False), model, hidden,
                           torch.as_tensor(batch["labels"]).to(dev), use_kernel=use_kernel)


def kv_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None, n_kv: Optional[int] = None):
    """The decoder's self-attention caches: k, v [L_dec, B, max_len, kv, hd]
    (``n_kv``: the kv heads a rank holds under tensor parallelism; all of
    them by default)."""
    shape = (cfg.dec_layers, batch, max_len, n_kv or cfg.n_kv, cfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _logits(cfg: ModelConfig, model: EncDecLM, hidden, use_kernel):
    """The head's logits [..., V]; a vocab-parallel ``unembed`` computes
    the rank's block of V and gathers the others'."""
    if not model.vocab_parallel:
        return dense(hidden, model.unembed, site_for(cfg.numerics, "lm_head"),
                     use_kernel=use_kernel)
    logits = dense(copy_model(hidden), model.unembed, site_for(cfg.numerics, "lm_head"),
                   use_kernel=use_kernel)
    return gather_model(logits, -1)


@torch.no_grad()
def prefill(cfg: ModelConfig, model: EncDecLM, frames, tokens, kv_caches,
            use_kernel: Optional[bool] = None):
    """Encode ``frames``, then run the target prefix ``tokens`` [B, S]
    through the decoder, writing the caches from position 0.  Returns
    (logits [B, 1, V] at the last token, kv_caches)."""
    enc_out = encode(cfg, model, frames, use_kernel)
    b, s = tokens.shape
    y = embed_tokens(cfg, model, tokens)
    hidden, kv_caches = _decoder(cfg, model, y, _positions(b, s, 0, tokens.device), enc_out,
                                 kv_caches=kv_caches, cache_len=0, use_kernel=use_kernel)
    return _logits(cfg, model, hidden[:, -1:, :], use_kernel), kv_caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: EncDecLM, token, enc_out, kv_caches,
                cache_len: int, use_kernel: Optional[bool] = None):
    """One-token decode of the batch at ``cache_len`` over the encoder
    output ``enc_out``.  Returns (logits [B, 1, V], kv_caches)."""
    b = token.shape[0]
    y = embed_tokens(cfg, model, token)
    hidden, kv_caches = _decoder(cfg, model, y, _positions(b, 1, cache_len, token.device),
                                 enc_out, kv_caches=kv_caches, cache_len=cache_len,
                                 use_kernel=use_kernel)
    return _logits(cfg, model, hidden, use_kernel), kv_caches
