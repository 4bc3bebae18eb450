"""Zamba2-style hybrid: a Mamba2 backbone and one shared attention block.

Port of ``repro/models/hybrid.py``.  The shared transformer block (one
set of weights) runs after every ``shared_attn_every`` Mamba2 layers;
its input is concat(hidden, the original embeddings), 2 * d_model wide,
and its output is projected back to d_model (site ``hybrid.proj``).
Its sites resolve layer-free, as the reference's
``bind(cfg.numerics, None, cfg.n_layers)``.  Each invocation has its
own slot of the shared KV cache.

Caches: {"ssm": the Mamba2 caches of ``mamba_lm``, "shared_k" /
"shared_v": [n_inv, B, S, kv, 2 * d_model / n_heads]}.  The static
engine does not grow them past the prompt (neither does the
reference's), so a decode step writes its K/V onto the cache's last
slot and attends to every key there, as the reference's
``dynamic_update_slice`` and causal mask do.

Under tensor parallelism (``parallel/sharding.py``) the Mamba2 layers
are ``mamba_lm``'s; the shared attention and MLP are column- and
row-parallel, as the dense family's, their K/V caches the rank's kv
heads; ``shared/out_proj`` [2d, d] is row-parallel over the replicated
concat, which enters it through ``model_block``.  With ``seq_parallel``
(a decode step at global batch 1, the reference's ``batch_shardings``)
each data rank holds S / data positions of the shared K/V
(:func:`seq_shard_caches`) and the decode attention merges the ranks'
partial softmaxes (``attention.py::attn_apply``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dense import dense, dense_init
from repro_torch.core.policy import bind, site
from repro_torch.parallel.sharding import current_mesh, kv_heads_for_rank, model_block, \
    shard_model

from .attention import Attention, attn_apply
from .common import RMSNorm, iter_layers, rmsnorm
from .mamba_lm import MambaBlock, embed_init, run_layer, store_states
from .mamba_lm import cache_init as ssm_cache_init
from .mlp import MLP, mlp_apply
from .transformer import (default_positions, embed_tokens, lm_logits, lm_loss_chunked,
                          torch_dtype)


class SharedBlock(nn.Module):
    """``ln1``, ``attn`` (heads of 2 * d_model / n_heads), ``ln2``,
    ``mlp`` over 2 * d_model, and ``out_proj`` [2 * d_model, d_model]
    (``row_parallel``: its rows cut for a mesh)."""

    row_parallel = False

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        d2 = 2 * cfg.d_model
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = RMSNorm(d2, device=device, dtype=dtype)
        self.attn = Attention(d2, cfg.n_heads, cfg.n_kv, d2 // cfg.n_heads, **kw)
        self.ln2 = RMSNorm(d2, device=device, dtype=dtype)
        self.mlp = MLP(d2, cfg.d_ff, cfg.glu, **kw)
        self.out_proj = nn.Parameter(dense_init(d2, cfg.d_model, **kw), requires_grad=False)


class HybridLM(nn.Module):
    """``embed``, ``blocks[i].{ln, mamba}``, ``shared``, ``ln_f``,
    ``unembed``, in the reference's layout."""

    vocab_parallel = False
    tp_shard = None

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        dtype = torch_dtype(cfg.param_dtype)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = nn.Parameter(embed_init(cfg.vocab, cfg.d_model, **kw),
                                  requires_grad=False)
        self.blocks = nn.ModuleList(MambaBlock(cfg, **kw) for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, **kw)
        self.ln_f = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.unembed = nn.Parameter(dense_init(cfg.d_model, cfg.vocab, **kw),
                                    requires_grad=False)
        for p in self.parameters():
            p.requires_grad_(False)


def hybrid_init(cfg: ModelConfig, *, seed: int = 0, device=None, mesh=None) -> HybridLM:
    """The port's own seeded init on ``device`` (CUDA by default; on
    ``"meta"`` shapes and dtypes only, ``device.init_generator``); under a
    ``mesh``, drawn whole and cut to this rank's shard."""
    from repro_torch.device import init_generator, resolve_device

    device = resolve_device(device)
    gen = init_generator(device, seed)
    return shard_model(HybridLM(cfg, generator=gen, device=device), cfg, mesh)


def n_shared_invocations(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every


def _shared_block(cfg: ModelConfig, sp: SharedBlock, x, x0, positions, kv_slice,
                  cache_len, use_kernel, seq_parallel: bool = False):
    """concat(hidden, embeds) -> shared attention and MLP -> projected back
    to d_model and added to the hidden state."""
    d2 = 2 * cfg.d_model
    nsite = bind(cfg.numerics, None, cfg.n_layers)
    cat = torch.cat([x, x0], dim=-1)
    h, new_kv = attn_apply(
        sp.attn, rmsnorm(sp.ln1, cat), nsite,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=d2 // cfg.n_heads,
        positions=positions, rope_theta=cfg.rope_theta,
        kv_cache=kv_slice, cache_len=cache_len, use_kernel=use_kernel,
        seq_parallel=seq_parallel,
    )
    cat = cat + h
    cat = cat + mlp_apply(sp.mlp, rmsnorm(sp.ln2, cat), nsite, cfg.act, use_kernel=use_kernel)
    if sp.row_parallel:  # this rank's rows of out_proj read its block of the concat
        cat = model_block(cat, -1)
    return x + dense(cat, sp.out_proj, site(nsite, "hybrid.proj"), use_kernel=use_kernel,
                     reduce=sp.row_parallel), new_kv


def hybrid_backbone(cfg: ModelConfig, model: HybridLM, embeds, positions, caches=None,
                    cache_len: Optional[int] = None, use_kernel: Optional[bool] = None,
                    seq_parallel: bool = False):
    """Run the Mamba2 layers with the shared block after every
    ``shared_attn_every`` of them.  caches: None, or the dict of
    :func:`cache_init` (its shared K/V written in place at ``cache_len``;
    with ``seq_parallel``, this data rank's positions of them).
    Returns (hidden after ln_f, new caches or None)."""
    x, x0 = embeds, embeds
    every = cfg.shared_attn_every
    states = []
    for i, nsite in iter_layers(cfg.numerics, cfg.n_layers):
        x, nc = run_layer(cfg, nsite, model.blocks[i], x, None if caches is None
                          else caches["ssm"], i, use_kernel)
        states.append(nc)
        if (i + 1) % every == 0:
            inv = (i + 1) // every - 1
            kv_slice = None if caches is None else (caches["shared_k"][inv],
                                                   caches["shared_v"][inv])
            x, _ = _shared_block(cfg, model.shared, x, x0, positions, kv_slice, cache_len,
                                 use_kernel, seq_parallel)
    hidden = rmsnorm(model.ln_f, x)
    if caches is None:
        return hidden, None
    caches = dict(caches, ssm=store_states(caches["ssm"], states, embeds.shape[1]))
    return hidden, caches


def train_loss(cfg: ModelConfig, model: HybridLM, batch, use_kernel: Optional[bool] = None):
    """batch: {tokens [B, S], labels [B, S]}.  The shared block's weights
    take the sum of their invocations' gradients, and the embeddings
    those of the Mamba2 stack and of every invocation's concat."""
    dev = model.embed.device
    tokens = torch.as_tensor(batch["tokens"]).to(dev)
    b, s = tokens.shape
    hidden, _ = hybrid_backbone(cfg, model, embed_tokens(cfg, model, tokens),
                                default_positions(cfg, b, s, device=dev), use_kernel=use_kernel)
    return lm_loss_chunked(cfg, model, hidden, torch.as_tensor(batch["labels"]).to(dev),
                           use_kernel=use_kernel)


def cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Zero caches; under the current mesh a model rank's Mamba2 heads and
    channels and its shared kv heads (``kv_heads_for_rank``)."""
    mesh = current_mesh()
    hd2 = 2 * cfg.d_model // cfg.n_heads
    n_kv = cfg.n_kv if mesh is None else len(kv_heads_for_rank(
        cfg.n_heads, cfg.n_kv, mesh.model_size, mesh.model_rank))
    kv_shape = (n_shared_invocations(cfg), batch, max_len, n_kv, hd2)
    return {"ssm": ssm_cache_init(cfg, batch, max_len, dtype, device),
            "shared_k": torch.zeros(kv_shape, dtype=dtype, device=device),
            "shared_v": torch.zeros(kv_shape, dtype=dtype, device=device)}


@torch.no_grad()
def prefill(cfg: ModelConfig, model: HybridLM, tokens, caches,
            use_kernel: Optional[bool] = None):
    """tokens [B, S] over caches of S positions -> (logits [B, 1, V] at the
    last token, caches)."""
    b, s = tokens.shape
    positions = default_positions(cfg, b, s, device=tokens.device)
    hidden, caches = hybrid_backbone(cfg, model, embed_tokens(cfg, model, tokens), positions,
                                     caches, 0, use_kernel)
    return lm_logits(cfg, model, hidden[:, -1:, :], use_kernel), caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: HybridLM, token, caches, cache_len: int,
                use_kernel: Optional[bool] = None, seq_parallel: bool = False):
    """token [B, 1] at position ``cache_len`` -> (logits [B, 1, V], caches).
    ``seq_parallel``: the shared K/V hold this data rank's positions
    (:func:`seq_shard_caches`)."""
    b = token.shape[0]
    positions = default_positions(cfg, b, 1, offset=cache_len, device=token.device)
    hidden, caches = hybrid_backbone(cfg, model, embed_tokens(cfg, model, token), positions,
                                     caches, cache_len, use_kernel, seq_parallel)
    return lm_logits(cfg, model, hidden, use_kernel), caches


def seq_shard_caches(caches, mesh):
    """Caches whose shared K/V keep this data rank's block of positions
    (S / data of them; the reference's ``seq`` on the ``data`` axis of a
    global-batch-1 decode), for :func:`decode_step` with
    ``seq_parallel``; the Mamba2 state is every data rank's."""
    n = caches["shared_k"].shape[2] // mesh.data_size
    part = {k: caches[k].narrow(2, mesh.data_rank * n, n).clone()
            for k in ("shared_k", "shared_v")}
    return dict(caches, **part)
