"""Mixture-of-Experts layer: top-k routing, capacity-based dispatch.

Port of ``repro/models/moe.py``, a dropping MoE: tokens are scattered
into per-expert capacity buffers (overflow dropped), the experts run as
stacked matmuls, and their outputs are combined with the gate
probabilities.  DeepSeekMoE-style shared experts (always on) run beside
the routed ones.

Numerics sites: ``moe.router`` (the policy's baseline rule keeps it
exact f32, since routing is control flow), ``moe.expert.{up,gate,down}``
for the routed experts and ``moe.shared.{up,gate,down}`` for the shared
ones.  Each routed projection is one ``nmatmul`` over the stack of all
experts ([E, C, K] x [E, K, N]), which under ``plam_sim`` is one PLAM
kernel launch over every expert (``kernels/plam_matmul.py``).

The dispatch couples the tokens of a forward: an expert keeps at most
``cap`` rows, ranked in token-major, k-minor order, so a token's output
depends on every row before it.  The port computes the reference's
ranks on the reference's rows, in the reference's order, and writes the
expert buffer with kept rows only (no float atomics, so the write is
deterministic on the card).  Top-k ties go to the lower expert index,
as ``jax.lax.top_k`` breaks them.

Under autograd (``train_loss``) the router's gradient flows through the
softmax and the top-k values of the stable sort, the experts' through
their stacked ``nmatmul``, and the dispatch's through its gather: the
backward of the buffer's ``index_copy_`` reads each row's gradient back
from its slot, and the dropped rows read the scratch row, which nothing
reads, so they get zero.  The routing is a function of the layer's
input alone, so a remat recompute routes exactly as its forward did.
``aux_load_balance_loss`` is the reference's Switch-style auxiliary loss;
like the reference's ``train_loss``, the port's does not add it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.dense import dense_init
from repro_torch.core.modes import matmul_sums, nmatmul, round_sums
from repro_torch.core.policy import SiteNumerics, site
from repro_torch.parallel.sharding import copy_model, current_mesh, data_offsets, reduce_model

from .mlp import ACTS, MLP, mlp_apply


def expert_init(n_experts: int, d_in: int, d_out: int, *, generator: torch.Generator,
                device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A stack of E [d_in, d_out] weights drawn from N(0, d_in^-1), as
    ``dense_init`` draws one (in f32, then cast: one stack at a time)."""
    w = torch.randn((n_experts, d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32)
    return (w * d_in ** -0.5).to(dtype)


class MoE(nn.Module):
    """``router`` [d, E] f32; ``wg``, ``wu`` [E, d, f] and ``wd`` [E, f, d]
    in the parameter dtype; ``shared``, an MLP of width f * n_shared, when
    there are shared experts.  Every expert is gated, as in the reference.

    Under tensor parallelism (``parallel/sharding.py``) the router stays
    whole and each expert is cut inside: a rank holds its block of f of
    every expert (``wg``/``wu`` [E, d, f/tp], ``wd`` [E, f/tp, d]:
    ``row_parallel``), and the shared experts' MLP its block of theirs."""

    row_parallel = False

    def __init__(self, d: int, n_experts: int, moe_d_ff: int, n_shared: int,
                 shared_d_ff: int, glu: bool, *, generator, device, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device)

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        self.router = param(dense_init(d, n_experts, dtype=torch.float32, **kw))
        self.wg = param(expert_init(n_experts, d, moe_d_ff, dtype=dtype, **kw))
        self.wu = param(expert_init(n_experts, d, moe_d_ff, dtype=dtype, **kw))
        self.wd = param(expert_init(n_experts, moe_d_ff, d, dtype=dtype, **kw))
        self.shared = (MLP(d, shared_d_ff * n_shared, glu, dtype=dtype, **kw)
                       if n_shared else None)


def route(router_logits: torch.Tensor, top_k: int, cap: int):
    """The reference's routing of one token group.

    router_logits: f32 [T, E].  Returns (gate f32 [T, k], renormalised;
    eid [T*k] the chosen experts, token-major and k-minor; pos [T*k] each
    row's rank within its expert; keep [T*k] = pos < cap).
    """
    n_experts = router_logits.shape[-1]
    # jax.nn.softmax's arithmetic
    z = torch.exp(router_logits - router_logits.amax(dim=-1, keepdim=True))
    probs = z / z.sum(dim=-1, keepdim=True)
    # jax.lax.top_k: descending, ties to the lower index (a stable sort)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eid = order.values[:, :top_k], order.indices[:, :top_k]
    gate = gate / gate.sum(dim=-1, keepdim=True)
    eid = eid.reshape(-1)
    oh = nn.functional.one_hot(eid, n_experts).to(torch.int32)
    pos = (torch.cumsum(oh, dim=0, dtype=torch.int32) - oh).gather(1, eid[:, None])[:, 0]
    return gate, eid, pos, pos < cap


def spread_routing(routing, n_experts: int, cap: int):
    """The routing of this data rank's block of a token group that runs
    over the mesh's data ranks: each expert's ranks offset by the rows the
    earlier data ranks gave it (``data_offsets``), and kept by the
    group's capacity."""
    gate, eid, pos, _ = routing
    counts = nn.functional.one_hot(eid, n_experts).sum(dim=0, dtype=torch.int32)
    pos = pos + data_offsets(counts)[eid]
    return gate, eid, pos, pos < cap


def dispatch(xf: torch.Tensor, eid, pos, keep, n_experts: int, cap: int) -> torch.Tensor:
    """The [E, cap, d] expert buffer: row ``xf[t]`` at ``[eid, pos]`` for
    every kept (token, choice), zero elsewhere.  Dropped rows go to a
    scratch row past the buffer, so that no kept row is written twice."""
    t, d = xf.shape
    tok = torch.arange(t, device=xf.device).repeat_interleave(eid.shape[0] // t)
    scratch = n_experts * cap
    slot = torch.where(keep, eid * cap + pos, torch.full_like(eid, scratch))
    buf = torch.zeros((scratch + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_copy_(0, slot, xf[tok])
    return buf[:scratch].view(n_experts, cap, d)


def experts_apply(p: MoE, buf: torch.Tensor, ncfg: SiteNumerics, act: str,
                  use_kernel: Optional[bool] = None, sums: bool = False) -> torch.Tensor:
    """The routed experts' gated FFN on their buffers, [E, C, d] -> [E, C, d]:
    three ``nmatmul`` calls over the whole stack, outputs in the activation
    dtype (the reference's ``jax.vmap(expert)``); with ``sums`` the down
    projection's f32 sums, unrounded (a rank's partial sums under tensor
    parallelism)."""
    fn = ACTS[act]
    kw = dict(out_dtype=buf.dtype, use_kernel=use_kernel)
    up = nmatmul(buf, p.wu, site(ncfg, "moe.expert.up"), **kw)
    up = fn(nmatmul(buf, p.wg, site(ncfg, "moe.expert.gate"), **kw)) * up
    if sums:
        return matmul_sums(up, p.wd, site(ncfg, "moe.expert.down"), use_kernel=use_kernel)
    return nmatmul(up, p.wd, site(ncfg, "moe.expert.down"), **kw)


def _dispatch_group(p: MoE, xf, router_logits, ncfg, *, top_k: int, cap: int, act: str,
                    use_kernel, sums: bool = False, spread: bool = False):
    """Capacity dispatch and the expert FFNs for ONE token group xf [Tg, d]
    (this data rank's block of it with ``spread``): (the experts' output
    buffer [E, cap, d], the group's routing).  With ``sums`` the buffer
    holds the down projection's f32 sums (a rank's partial sums under
    tensor parallelism)."""
    n_experts = router_logits.shape[-1]
    routing = route(router_logits, top_k, cap)
    if spread:
        routing = spread_routing(routing, n_experts, cap)
    _, eid, pos, keep = routing
    out_buf = experts_apply(p, dispatch(xf, eid, pos, keep, n_experts, cap), ncfg, act,
                            use_kernel, sums=sums)
    return out_buf, routing


def _combine(out_buf, routing, top_k: int, cap: int, dtype):
    """The gate-weighted sum of each token's kept expert rows, [Tg, d]."""
    gate, eid, pos, keep = routing
    n_experts, _, d = out_buf.shape
    rows = torch.where(keep, eid * cap + pos, torch.zeros_like(eid))
    gathered = out_buf.reshape(n_experts * cap, d)[rows]
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    weighted = gathered.reshape(-1, top_k, d) * gate[..., None].to(dtype)
    # jnp.sum over a bf16 axis adds in f32 and rounds once
    return weighted.sum(dim=1, dtype=torch.float32).to(dtype)


def moe_apply(p: MoE, x: torch.Tensor, ncfg: SiteNumerics, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, act: str = "silu", groups: int = 1,
              use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d].

    ``groups > 1`` dispatches each of ``groups`` contiguous token groups
    on its own (capacity, ranks and drops group-local), as the reference
    does under its data-parallel sharding; ``groups`` that do not divide
    the tokens fall back to one group, as there.  The groups are those of
    the global batch: under a mesh's data axis a rank dispatches its whole
    groups, or its block of the one group (capacity ranks offset by the
    earlier data ranks' rows).

    Under tensor parallelism the cut experts' f32 partial sums (the
    routed experts' buffers and the shared experts' output) are added
    over the ranks in ONE reduction, then rounded and combined as one rank
    rounds and combines the whole sums, so that the two differ only in the
    order of the partial sums' addition.
    """
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    logits = nmatmul(xf, p.router, site(ncfg, "moe.router"), out_dtype=torch.float32,
                     use_kernel=use_kernel)
    mesh = current_mesh()
    data = 1 if mesh is None else mesh.batch_size
    g_all = groups if (t * data) % max(groups, 1) == 0 else 1
    if g_all % data and g_all != 1:
        raise ValueError(f"{g_all} MoE dispatch groups over {data} data ranks")
    g = g_all // data if g_all % data == 0 else 1
    tg = t // g
    cap = max(1, int(t * data // g_all * top_k / n_experts * capacity_factor))
    kw = dict(top_k=top_k, cap=cap, act=act, use_kernel=use_kernel, sums=p.row_parallel,
              spread=g_all % data != 0)
    shared_cut = p.shared is not None and p.shared.row_parallel
    # the router reads x as it is; the cut experts' (and shared experts')
    # up projections read it through ONE copy_model
    xc = copy_model(xf) if p.row_parallel or shared_cut else xf
    x_exp = xc if p.row_parallel else xf
    grouped = [_dispatch_group(p, xg, lg, ncfg, **kw)
               for xg, lg in zip(x_exp.reshape(g, tg, d), logits.reshape(g, tg, n_experts))]
    bufs = [buf for buf, _ in grouped]
    shared = None if p.shared is None else mlp_apply(
        p.shared, xc if shared_cut else xf, ncfg, act, role="moe.shared",
        use_kernel=use_kernel, partial=shared_cut)
    cut = (bufs if p.row_parallel else []) + ([shared] if shared_cut else [])
    if cut:
        sums = reduce_model(torch.cat([c.reshape(-1, d) for c in cut]))
        sums = list(sums.split([c.numel() // d for c in cut]))
        if p.row_parallel:
            down = site(ncfg, "moe.expert.down")
            bufs = [round_sums(sums.pop(0).view_as(buf), down, xf.dtype) for buf in bufs]
        if shared_cut:
            shared = round_sums(sums.pop(0), site(ncfg, "moe.shared.down"), xf.dtype)
    combined = [_combine(buf, routing, top_k, cap, xf.dtype)
                for buf, (_, routing) in zip(bufs, grouped)]
    combined = combined[0] if g == 1 else torch.cat(combined)
    if shared is not None:
        combined = combined + shared
    return combined.reshape(b, s, d)


def aux_load_balance_loss(logits: torch.Tensor, eid: torch.Tensor, n_experts: int):
    """Switch-style load-balance auxiliary loss (mean prob x mean load):
    logits [T, E], eid [T, k] the chosen experts (the first choice
    counts)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    load = torch.mean(nn.functional.one_hot(eid[..., 0].to(torch.long), n_experts)
                      .to(torch.float32), dim=0)
    imp = torch.mean(probs, dim=0)
    return n_experts * torch.sum(imp * load)
