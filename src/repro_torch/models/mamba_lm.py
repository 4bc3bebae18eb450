"""Attention-free Mamba2 LM (mamba2-780m).

Port of ``repro/models/mamba_lm.py``.  Numerics sites: ``ssm.proj.in``
and ``ssm.proj.out`` inside each block, ``lm_head`` for the
unembedding.  Layer-range policy rules bind each block to its segment's
numerics (``common.iter_layers``), as the reference's
``scan_policy_segments`` does.

Caches: {"h": [L, B, H, ds, hd] f32, "conv": [L, B, K-1, conv_dim]}.
A prefill returns new caches with the dtypes the reference's scan gives
them (``h`` f32, ``conv`` in the activation dtype, whatever the dtype of
the caches handed in); a decode step writes them in place where the
dtypes already agree.

Under tensor parallelism (``parallel/sharding.py``) a rank holds its
shard (``mamba_lm_init(mesh=...)``): its block of the vocabulary of
``embed`` and ``unembed`` where the vocabulary divides tp, looked up and
gathered as the transformer's (``transformer.py::embed_tokens``,
``lm_logits``), and each mixer's heads and channels (``ssm.py``); its
caches hold the rank's heads and channels (:func:`cache_init`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dense import dense_init
from repro_torch.parallel.sharding import current_mesh, shard_model

from .common import RMSNorm, iter_layers, rmsnorm
from .ssm import Mamba2, mamba2_apply, mamba2_cache_init
from .transformer import embed_tokens, lm_logits, lm_loss_chunked, torch_dtype


def ssm_kw(cfg: ModelConfig):
    return dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                d_state=cfg.ssm_state, chunk=cfg.ssm_chunk)


class MambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.mamba = Mamba2(cfg.d_model, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                            d_state=cfg.ssm_state, d_conv=cfg.ssm_conv,
                            generator=generator, device=device, dtype=dtype)


def embed_init(vocab: int, d: int, *, generator, device, dtype):
    return (torch.randn((vocab, d), generator=generator, device=device)
            * d ** -0.5).to(dtype)


class MambaLM(nn.Module):
    """``embed`` [V, d], ``blocks[i].{ln, mamba}``, ``ln_f``, ``unembed``
    [d, V], in the reference's layout (its [L] axis split across blocks).
    ``vocab_parallel`` and ``tp_shard``: as ``transformer.DenseLM``'s."""

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
        self.ln_f = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.unembed = nn.Parameter(dense_init(cfg.d_model, cfg.vocab, **kw),
                                    requires_grad=False)
        for p in self.parameters():
            p.requires_grad_(False)


def mamba_lm_init(cfg: ModelConfig, *, seed: int = 0, device=None, mesh=None) -> MambaLM:
    """The port's own seeded init on ``device`` (CUDA by default; on
    ``"meta"`` shapes and dtypes only, ``device.init_generator``); under a
    ``mesh``, drawn whole and cut to this rank's shard
    (``parallel/sharding.py::shard_model``)."""
    from repro_torch.device import init_generator, resolve_device

    device = resolve_device(device)
    gen = init_generator(device, seed)
    return shard_model(MambaLM(cfg, generator=gen, device=device), cfg, mesh)


def run_layer(cfg: ModelConfig, nsite, blk: MambaBlock, x, caches, i: int, use_kernel):
    """x + the block's Mamba2 over rmsnorm(x); with ``caches``, layer i's
    state is read from them and its new state returned."""
    c = None if caches is None else {"h": caches["h"][i], "conv": caches["conv"][i]}
    h, nc = mamba2_apply(blk.mamba, rmsnorm(blk.ln, x), nsite, cache=c,
                         use_kernel=use_kernel, **ssm_kw(cfg))
    return x + h, nc


def store_states(caches, states, s: int):
    """The caches after a forward over ``s`` tokens: the per-layer states
    stacked into new tensors after a prefill (the reference's dtypes),
    or, after a one-token step, written into ``caches`` in place where
    the dtypes agree."""
    if s > 1 or any(caches[k].dtype != states[0][k].dtype or
                    caches[k].shape[1:] != states[0][k].shape for k in ("h", "conv")):
        return {k: torch.stack([st[k] for st in states]) for k in ("h", "conv")}
    for i, st in enumerate(states):
        caches["h"][i].copy_(st["h"])
        caches["conv"][i].copy_(st["conv"])
    return caches


def backbone(cfg: ModelConfig, model: MambaLM, embeds, caches=None,
             use_kernel: Optional[bool] = None):
    """Run the blocks.  Returns (hidden after ln_f, new caches or None)."""
    x = embeds
    states = []
    for i, nsite in iter_layers(cfg.numerics, cfg.n_layers):
        x, nc = run_layer(cfg, nsite, model.blocks[i], x, caches, i, use_kernel)
        states.append(nc)
    hidden = rmsnorm(model.ln_f, x)
    if caches is None:
        return hidden, None
    return hidden, store_states(caches, states, embeds.shape[1])


def train_loss(cfg: ModelConfig, model: MambaLM, batch, use_kernel: Optional[bool] = None):
    """batch: {tokens [B, S], labels [B, S]}.  The mean next-token
    cross-entropy through every block's chunked SSD scan."""
    dev = model.embed.device
    x = embed_tokens(cfg, model, torch.as_tensor(batch["tokens"]).to(dev))
    hidden, _ = backbone(cfg, model, x, use_kernel=use_kernel)
    return lm_loss_chunked(cfg, model, hidden, torch.as_tensor(batch["labels"]).to(dev),
                           use_kernel=use_kernel)


def cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Zero caches, [L, ...] each (``max_len`` is unused: the state is
    position-free); under the current mesh a model rank's heads and
    channels."""
    mesh = current_mesh()
    one = mamba2_cache_init(batch, cfg.d_model, expand=cfg.ssm_expand,
                            head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state,
                            d_conv=cfg.ssm_conv, dtype=dtype, device=device,
                            tp=1 if mesh is None else mesh.model_size)
    return {k: v[None].repeat(cfg.n_layers, *([1] * v.dim())) for k, v in one.items()}


@torch.no_grad()
def prefill(cfg: ModelConfig, model: MambaLM, tokens, caches,
            use_kernel: Optional[bool] = None):
    """tokens [B, S] -> (logits [B, 1, V] at the last token, caches)."""
    hidden, caches = backbone(cfg, model, embed_tokens(cfg, model, tokens), caches, use_kernel)
    return lm_logits(cfg, model, hidden[:, -1:, :], use_kernel), caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: MambaLM, token, caches, cache_len=None,
                use_kernel: Optional[bool] = None):
    """token [B, 1] -> (logits [B, 1, V], caches); the SSM state is
    position-free, so ``cache_len`` is unused."""
    del cache_len
    hidden, caches = backbone(cfg, model, embed_tokens(cfg, model, token), caches, use_kernel)
    return lm_logits(cfg, model, hidden, use_kernel), caches
