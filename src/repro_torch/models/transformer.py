"""Decoder-only transformer LM, dense, MoE and vlm families (port of
``repro/models/transformer.py``).

The model is an ``nn.Module``: token embedding, an ``nn.ModuleList`` of
blocks (the reference stacks layers on a leading [L] axis and scans
them) and the final norm and unembedding.  A block's FFN is an MLP, or
with ``cfg.n_experts`` a MoE layer (``models/moe.py``).  The vlm family
(the qwen2-vl backbone) is this model with M-RoPE (``cfg.mrope_sections``:
positions [3, B, S], all three rows equal for text) and a prefix of patch
embeddings ahead of the tokens (``models/registry.py``).  The functions
below mirror the reference's public entry points and take the model
where the reference takes its parameter pytree.

Numerics: every matmul resolves a *site* (``attn.qkv``, ``mlp.down``,
``lm_head``, ...) against ``cfg.numerics``; layer-range policy rules
bind each block to its segment's numerics.  ``use_kernel`` selects the
CUDA kernels or their plain versions (``repro_torch.kernels.ops``).

Training (``train_loss``, every family of this module): the model's
parameters are built frozen, for serving; :func:`set_trainable` makes
its float leaves trainable (those of every family's model).  With
``cfg.remat`` each layer runs under ``torch.utils.checkpoint`` (its
activations recomputed in the backward pass, as the reference's
``jax.checkpoint`` with ``nothing_saveable``), and the loss forms each
512-position chunk's logits under a checkpoint of its own.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dense import dense, dense_init
from repro_torch.core.policy import site_for
from repro_torch.parallel.sharding import (
    copy_model,
    current_mesh,
    data_sum,
    gather_model,
    reduce_model,
    sharded_init,
    use_mesh,
)

from .attention import Attention, attn_apply, attn_apply_paged, paged_write
from .common import RMSNorm, iter_layers, multi_token_positions, rmsnorm
from .mlp import MLP, mlp_apply
from .moe import MoE, moe_apply

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, **kw)
        self.ln2 = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        if cfg.n_experts:
            self.moe = MoE(cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.n_shared_experts,
                           cfg.moe_d_ff, cfg.glu, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.glu, **kw)


#: the families this module builds (ssm, hybrid and encdec have modules
#: of their own)
FAMILIES = ("dense", "moe", "vlm")


class DenseLM(nn.Module):
    """Parameters in the reference's layout: ``embed`` [V, d], per-block
    weights [d_in, d_out] (a MoE block's experts stacked [E, d_in,
    d_out]), ``ln_f``, and ``unembed`` [d, V] unless the embeddings are
    tied.  Built for the dense, MoE and vlm families.

    Under tensor parallelism (``parallel/sharding.py``) each rank holds
    its slice of the weights; ``vocab_parallel`` marks ``embed`` (and
    ``unembed``) cut to the rank's block of the vocabulary, which the
    lookup and the head then sum and gather over the ranks.  ``tp_shard``
    is (rank, tp) once the model is cut."""

    vocab_parallel = False
    tp_shard = None

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"family {cfg.family!r} is not a decoder-only transformer")
        dtype = torch_dtype(cfg.param_dtype)
        self.embed = nn.Parameter(
            (torch.randn((cfg.vocab, cfg.d_model), generator=generator, device=device)
             * cfg.d_model ** -0.5).to(dtype),
            requires_grad=False)
        self.blocks = nn.ModuleList(
            Block(cfg, generator=generator, device=device, dtype=dtype)
            for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, device=device, dtype=dtype)
        if cfg.tie_embeddings:
            self.unembed = None
        else:
            self.unembed = nn.Parameter(
                dense_init(cfg.d_model, cfg.vocab, generator=generator, device=device,
                           dtype=dtype),
                requires_grad=False)


def lm_init(cfg: ModelConfig, *, seed: int = 0, device=None, mesh=None) -> DenseLM:
    """The port's own seeded init, drawn on ``device`` (CUDA by default),
    one tensor at a time in f32 and cast to the parameter dtype, so that
    no f32 copy of the model is ever held (on ``"meta"`` shapes and
    dtypes only, ``device.init_generator``).  Under a ``mesh`` each
    tensor is cut to this rank's slice as soon as it is drawn
    (``parallel/sharding.py::sharded_init``): the values of
    ``shard_model`` of the whole model, with one whole tensor held at a
    time."""
    from repro_torch.device import init_generator, resolve_device

    device = resolve_device(device)
    gen = init_generator(device, seed)
    with sharded_init(cfg, mesh):
        model = DenseLM(cfg, generator=gen, device=device)
    if mesh is not None:
        model.tp_shard = (mesh.model_rank, mesh.model_size)
    return model


def _ffn_fwd(cfg: ModelConfig, nsite, blk: Block, hn, use_kernel):
    """The post-attention half of a block (MoE or dense MLP)."""
    if cfg.n_experts:
        return moe_apply(blk.moe, hn, nsite, n_experts=cfg.n_experts, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, act=cfg.act,
                         groups=cfg.moe_groups, use_kernel=use_kernel)
    return mlp_apply(blk.mlp, hn, nsite, cfg.act, use_kernel=use_kernel)


def _layer_fwd(cfg: ModelConfig, nsite, blk: Block, x, positions, kv_slice, cache_len,
               use_kernel):
    h, new_kv = attn_apply(
        blk.attn, rmsnorm(blk.ln1, x), nsite,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
        positions=positions, rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
        kv_cache=kv_slice, cache_len=cache_len,
        softcap=cfg.attn_logit_softcap, flash_block=cfg.flash_block, use_kernel=use_kernel,
    )
    x = x + h
    x = x + _ffn_fwd(cfg, nsite, blk, rmsnorm(blk.ln2, x), use_kernel)
    return x, new_kv


def lm_backbone(cfg: ModelConfig, model: DenseLM, embeds, positions, kv_caches=None,
                cache_len: Optional[int] = None, use_kernel: Optional[bool] = None):
    """Run the blocks.  Returns (hidden, kv_caches).

    kv_caches: None, or (k [L,B,S,kv,hd], v [L,...]) written in place at
    ``cache_len``.
    """
    x = embeds
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    remat = cfg.remat and kv_caches is None and torch.is_grad_enabled()
    mesh = current_mesh()
    for i, nsite in iter_layers(cfg.numerics, cfg.n_layers):
        kv_slice = None if kv_caches is None else (kv_caches[0][i], kv_caches[1][i])
        if remat:
            def layer(x, nsite=nsite, blk=model.blocks[i]):
                with use_mesh(mesh):  # the recompute may run on a device thread
                    return _layer_fwd(cfg, nsite, blk, x, positions, None, None,
                                      use_kernel)[0]

            x = checkpoint(layer, x, use_reentrant=False)
        else:
            x, _ = _layer_fwd(cfg, nsite, model.blocks[i], x, positions, kv_slice,
                              cache_len, use_kernel)
    return rmsnorm(model.ln_f, x), kv_caches


def lm_logits(cfg: ModelConfig, model: DenseLM, hidden, use_kernel: Optional[bool] = None):
    """The head's logits [..., V]; a vocab-parallel head computes its
    rank's block of V (column-parallel) and gathers the others', so that
    every rank holds all of them."""
    w = model.embed.T if cfg.tie_embeddings else model.unembed
    head_cfg = site_for(cfg.numerics, "lm_head", n_layers=cfg.n_layers)
    if w.is_floating_point():  # else prequantized lm_head patterns
        w = w.to(hidden.dtype)
    parallel = getattr(model, "vocab_parallel", False)  # the other families' models: never
    logits = dense(copy_model(hidden) if parallel else hidden, w, head_cfg,
                   use_kernel=use_kernel)
    return gather_model(logits, -1) if parallel else logits


def lm_loss_chunked(cfg: ModelConfig, model: DenseLM, hidden, labels, chunk: int = 512,
                    use_kernel: Optional[bool] = None):
    """Cross-entropy without forming [B, S, V] at once.

    Sequence chunks of ``chunk`` positions; each chunk's logits are
    formed, reduced and dropped, and formed again in the backward pass
    (``torch.utils.checkpoint``), so peak logits memory is B * chunk * V.
    Label -1 marks a masked position.  The mean is over unmasked
    positions; under a mesh with a data axis, over those of the global
    batch (``data_sum``), so that the ranks' losses add up to it.
    """
    s = hidden.shape[1]
    chunk = min(chunk, s)
    valid = (labels >= 0).to(torch.float32)
    labels = labels.clamp(min=0).to(torch.long)
    mesh = current_mesh()

    def chunk_loss(h, lab, v):
        with use_mesh(mesh):  # the recompute may run on a device thread
            return _chunk_loss(h, lab, v)

    def _chunk_loss(h, lab, v):
        logits = lm_logits(cfg, model, h, use_kernel).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        return torch.sum((lse - gold) * v)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        # the reference pads the last chunk; padded positions add 0
        part = (hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], valid[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            tot = tot + checkpoint(chunk_loss, *part, use_reentrant=False)
        else:
            tot = tot + chunk_loss(*part)
    return tot / torch.clamp(data_sum(valid.sum()), min=1.0)


def train_loss(cfg: ModelConfig, model: DenseLM, batch,
               use_kernel: Optional[bool] = None):
    """batch: {tokens [B, S], labels [B, S]} integer tensors (moved to the
    model's device), and for the vlm ``embeds_prefix`` [B, P, d]: the
    patch embeddings go ahead of the tokens' and their positions carry no
    target (label -1).  Returns the mean next-token cross-entropy, a
    scalar f32 tensor.  Under a mesh with a data axis the batch is this
    data rank's rows (``train/loop.py::local_rows`` cuts every leaf, the
    prefix too), the M-RoPE positions are the rows' own, and the mean is
    over the global batch's labels (:func:`lm_loss_chunked`).  A MoE
    block routes under autograd as it does in a forward (the gate's
    gradient through the softmax and the top-k values; the dispatch's
    through its gather); no auxiliary loss is added, as in the
    reference."""
    dev = model.embed.device
    tokens = torch.as_tensor(batch["tokens"]).to(dev)
    labels = torch.as_tensor(batch["labels"]).to(dev)
    b, s = tokens.shape
    x = embed_tokens(cfg, model, tokens)
    if "embeds_prefix" in batch:
        prefix = torch.as_tensor(batch["embeds_prefix"]).to(dev, x.dtype)
        x = torch.cat([prefix, x], dim=1)
        labels = torch.nn.functional.pad(labels, (x.shape[1] - s, 0), value=-1)
        s = x.shape[1]
    positions = default_positions(cfg, b, s, device=dev)
    hidden, _ = lm_backbone(cfg, model, x, positions, use_kernel=use_kernel)
    return lm_loss_chunked(cfg, model, hidden, labels, use_kernel=use_kernel)


def set_trainable(model: nn.Module, trainable: bool = True) -> nn.Module:
    """Make every float parameter of ``model`` trainable (or frozen
    again, for serving), in place.  Pattern (prequantized) weights stay
    frozen."""
    for p in model.parameters():
        p.requires_grad_(trainable and p.is_floating_point())
    return model


def embed_tokens(cfg: ModelConfig, model: DenseLM, tokens):
    """The tokens' embeddings in the activation dtype.  Vocab-parallel:
    each rank looks up the tokens of its block of the vocabulary, zero for
    the others', and the ranks' rows are summed in f32; one term of each
    sum is nonzero, so it is exact."""
    act = torch_dtype(cfg.act_dtype)
    if not getattr(model, "vocab_parallel", False):
        return model.embed[tokens.to(torch.long)].to(act)
    v = model.embed.shape[0]
    local = tokens.to(torch.long) - current_mesh().model_rank * v
    inside = (local >= 0) & (local < v)
    rows = model.embed[local.clamp(0, v - 1)].to(torch.float32)
    rows = torch.where(inside[..., None], rows, torch.zeros((), device=rows.device))
    return reduce_model(rows).to(act)


def default_positions(cfg: ModelConfig, b: int, s: int, offset: int = 0, device=None):
    """[B, S] positions from ``offset``; [3, B, S] with the one row
    broadcast under M-RoPE (text-only positions: all three sections
    equal)."""
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(b, s)
    return pos.expand(3, b, s) if cfg.mrope_sections else pos


def kv_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None, n_kv: Optional[int] = None):
    """Contiguous K/V caches [L, B, S, kv, hd] (``n_kv``: the kv heads a
    rank holds under tensor parallelism; all of them by default)."""
    shape = (cfg.n_layers, batch, max_len, n_kv or cfg.n_kv, cfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


@torch.no_grad()
def prefill(cfg: ModelConfig, model: DenseLM, tokens, kv_caches,
            use_kernel: Optional[bool] = None):
    """Full-sequence prefill of the static engine: writes the contiguous
    KV caches (k, v [L, B, S, kv, hd]) in place from position 0 and
    returns (logits [B, 1, V] at the last token, kv_caches)."""
    b, s = tokens.shape
    x = embed_tokens(cfg, model, tokens)
    positions = default_positions(cfg, b, s, device=tokens.device)
    hidden, kv_caches = lm_backbone(cfg, model, x, positions, kv_caches=kv_caches,
                                    cache_len=0, use_kernel=use_kernel)
    return lm_logits(cfg, model, hidden[:, -1:, :], use_kernel), kv_caches


@torch.no_grad()
def prefill_prefix(cfg: ModelConfig, model: DenseLM, tokens, embeds_prefix, kv_caches,
                   use_kernel: Optional[bool] = None):
    """The vlm's prefill: the patch embeddings [B, P, d] occupy the first P
    positions of the cache window, the tokens' embeddings the next S; the
    caches (k, v [L, B, >= P + S, kv, hd]) are written in place from
    position 0.  Returns (logits [B, 1, V] at the last token, kv_caches)."""
    b = tokens.shape[0]
    x = embed_tokens(cfg, model, tokens)
    x = torch.cat([torch.as_tensor(embeds_prefix).to(x.device, x.dtype), x], dim=1)
    positions = default_positions(cfg, b, x.shape[1], device=tokens.device)
    hidden, kv_caches = lm_backbone(cfg, model, x, positions, kv_caches=kv_caches,
                                    cache_len=0, use_kernel=use_kernel)
    return lm_logits(cfg, model, hidden[:, -1:, :], use_kernel), kv_caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: DenseLM, token, kv_caches, cache_len: int,
                use_kernel: Optional[bool] = None):
    """One-token decode of the whole batch at one shared offset.  token:
    [B, 1]; cache_len: the position the token is written at (clamped to
    the cache's last slot past its end, as the reference's).  Returns
    (logits [B, 1, V], kv_caches)."""
    b = token.shape[0]
    x = embed_tokens(cfg, model, token)
    positions = default_positions(cfg, b, 1, offset=cache_len, device=token.device)
    hidden, kv_caches = lm_backbone(cfg, model, x, positions, kv_caches=kv_caches,
                                    cache_len=cache_len, use_kernel=use_kernel)
    return lm_logits(cfg, model, hidden, use_kernel), kv_caches


def local_kv_heads(cfg: ModelConfig, model: DenseLM) -> int:
    """The kv heads ``model`` holds: all of them, or a rank's under tensor
    parallelism (``parallel/sharding.py::kv_heads_for_rank``)."""
    return model.blocks[0].attn.wk.shape[-1] // cfg.hd


def paged_kv_pool_init(cfg: ModelConfig, num_blocks: int, block_size: int,
                       dtype=torch.bfloat16, device=None, n_kv: Optional[int] = None):
    """Block-pool KV storage shared by all sequences: two tensors of
    shape [L, num_blocks, block_size, kv, hd].  Sequences own disjoint
    sets of blocks, named by their block tables (``repro_torch.serving``).
    ``n_kv``: the kv heads a rank holds under tensor parallelism
    (:func:`local_kv_heads`); all of them by default."""
    shape = (cfg.n_layers, num_blocks, block_size, n_kv or cfg.n_kv, cfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


@torch.no_grad()
def paged_prefill(cfg: ModelConfig, model: DenseLM, tokens, k_pool, v_pool, block_ids,
                  true_len: int, use_kernel: Optional[bool] = None):
    """Prefill ONE request into pool blocks.

    tokens: [1, S_pad] right-padded to a block-size multiple; block_ids:
    [S_pad / block_size] pool blocks owned by this request; true_len:
    the real prompt length.  The prompt's K/V are written into the pools
    in place.  Returns (logits [1, 1, V] at the last real token,
    (k_pool, v_pool)).
    """
    b, s = tokens.shape
    if b != 1:
        raise ValueError("paged prefill admits one request at a time")
    block_size = k_pool.shape[2]
    nb = block_ids.shape[0]
    if s != nb * block_size:
        raise ValueError(f"{s} tokens do not fill {nb} blocks of {block_size}")
    dev = tokens.device
    n_kv = k_pool.shape[3]  # this rank's kv heads
    caches = kv_cache_init(cfg, b, s, k_pool.dtype, device=dev, n_kv=n_kv)
    x = embed_tokens(cfg, model, tokens)
    positions = default_positions(cfg, b, s, device=dev)
    hidden, (ck, cv) = lm_backbone(cfg, model, x, positions, kv_caches=caches,
                                   cache_len=0, use_kernel=use_kernel)
    kv_shape = (cfg.n_layers, nb, block_size, n_kv, cfg.hd)
    ids = block_ids.to(torch.long)
    k_pool[:, ids] = ck[:, 0].reshape(kv_shape)
    v_pool[:, ids] = cv[:, 0].reshape(kv_shape)
    last = hidden[:, true_len - 1:true_len]
    return lm_logits(cfg, model, last, use_kernel), (k_pool, v_pool)


def _paged_gather_forward(cfg: ModelConfig, model: DenseLM, tokens, k_pool, v_pool,
                          block_tables, lengths, use_kernel: Optional[bool] = None):
    """The gather -> attend -> write machinery of every multi-token paged
    path (chunked prefill, speculative verify).

    tokens: [B, W] a token span per slot; block_tables: int32 [B, max_blk]
    full table rows (scratch-padded); lengths: int32 [B] tokens already
    cached per slot, so token j of slot b sits at position
    ``lengths[b] + j``.  Layer by layer, each slot's blocks are gathered
    into a contiguous [B, S, kv, hd] cache, the span runs through
    ``attn_apply`` with per-slot offsets, and the span's K/V are written
    into the pools in place.  A position past a slot's owned blocks goes
    through the padded table row to scratch block 0, which no live mask
    admits; an offset past ``S - W`` is clamped as in the reference, so
    nothing is written out of bounds.  Returns (hidden [B, W, d] after
    the final norm, (k_pool, v_pool)).
    """
    b, w = tokens.shape
    block_size = k_pool.shape[2]
    s = block_tables.shape[1] * block_size
    dev = tokens.device
    tables = block_tables.to(torch.long)
    flat = tables.reshape(-1)
    # the cache rows the span lands on, and their (block, offset) in the pool
    rows = lengths.to(torch.long).clamp(0, s - w)[:, None] + torch.arange(w, device=dev)
    bidx = torch.arange(b, device=dev)[:, None]
    blk = tables.gather(1, rows // block_size)
    off = rows % block_size
    x = embed_tokens(cfg, model, tokens)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    positions = multi_token_positions(lengths, w)
    for i, nsite in iter_layers(cfg.numerics, cfg.n_layers):
        kp, vp = k_pool[i], v_pool[i]
        ck = kp[flat].reshape(b, s, *kp.shape[2:])
        cv = vp[flat].reshape(b, s, *vp.shape[2:])
        x, _ = _layer_fwd(cfg, nsite, model.blocks[i], x, positions, (ck, cv), lengths,
                          use_kernel)
        kp.index_put_((blk, off), ck[bidx, rows])
        vp.index_put_((blk, off), cv[bidx, rows])
    return rmsnorm(model.ln_f, x), (k_pool, v_pool)


@torch.no_grad()
def paged_prefill_chunk(cfg: ModelConfig, model: DenseLM, tokens, k_pool, v_pool,
                        block_ids, cache_len: int, last_idx: int,
                        use_kernel: Optional[bool] = None):
    """Prefill ONE chunk of one request through the multi-token path.

    tokens: [1, C], C the engine's chunk width (a block-size multiple;
    the ragged final chunk right-padded to a block multiple); block_ids:
    int32 [max_blk] the request's full, scratch-padded table row;
    cache_len: prompt tokens already cached; last_idx: chunk-local index
    of the last real token, whose logits seed decoding on the final
    chunk.  Padding past the real tokens is written beyond them, where
    the causal mask never reads it before decode overwrites it.
    Returns (logits [1, 1, V] at last_idx, (k_pool, v_pool)).
    """
    if tokens.shape[0] != 1:
        raise ValueError("chunked prefill admits one request at a time")
    lengths = torch.tensor([cache_len], dtype=torch.int32, device=tokens.device)
    hidden, pools = _paged_gather_forward(cfg, model, tokens, k_pool, v_pool,
                                          block_ids[None, :], lengths, use_kernel)
    last = hidden[:, last_idx:last_idx + 1]
    return lm_logits(cfg, model, last, use_kernel), pools


@torch.no_grad()
def paged_score_tokens(cfg: ModelConfig, model: DenseLM, tokens, k_pool, v_pool,
                       block_tables, lengths, use_kernel: Optional[bool] = None):
    """Score a W-token span per slot in one batched call (the speculative
    verify step).

    tokens: [B, W], token 0 each slot's last sampled, uncached token and
    tokens 1..W-1 its drafts; block_tables: int32 [B, max_blk]; lengths:
    int32 [B] committed cache length per slot.  Writes K/V for all W
    tokens at lengths..lengths+W-1 (the engine rolls rejected tails back)
    and returns (logits [B, W, V], (k_pool, v_pool)): logits[:, j] is the
    distribution of the token after tokens[:, j].
    """
    hidden, pools = _paged_gather_forward(cfg, model, tokens, k_pool, v_pool,
                                          block_tables, lengths, use_kernel)
    return lm_logits(cfg, model, hidden, use_kernel), pools


@torch.no_grad()
def paged_decode_step(cfg: ModelConfig, model: DenseLM, token, k_pool, v_pool,
                      block_tables, lengths, use_kernel: Optional[bool] = None):
    """One decode step for a heterogeneous batch over the paged cache.

    token: [B, 1] last token per slot; block_tables: int32 [B, max_blk]
    pool indices (inactive slots point at the reserved scratch block 0);
    lengths: int32 [B] per-sequence cached-token counts.  The new K/V
    are written into the pools in place.  Returns (logits [B, 1, V],
    (k_pool, v_pool)).
    """
    x = embed_tokens(cfg, model, token)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    write = paged_write(lengths, block_tables, k_pool.shape[2])
    for i, nsite in iter_layers(cfg.numerics, cfg.n_layers):
        blk = model.blocks[i]
        h, _ = attn_apply_paged(
            blk.attn, rmsnorm(blk.ln1, x), nsite,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
            lengths=lengths, k_pages=k_pool[i], v_pages=v_pool[i],
            block_tables=block_tables, write=write, rope_theta=cfg.rope_theta,
            softcap=cfg.attn_logit_softcap, use_kernel=use_kernel,
        )
        x = x + h
        x = x + _ffn_fwd(cfg, nsite, blk, rmsnorm(blk.ln2, x), use_kernel)
    x = rmsnorm(model.ln_f, x)
    return lm_logits(cfg, model, x, use_kernel), (k_pool, v_pool)
