"""Tensor-parallel sharding rules and collectives (port of
``repro/parallel/sharding.py``).

The reference names logical axes and lets GSPMD place its arrays.  The
port runs one process a rank (``launch/mesh.py``) on a (data, model)
:class:`Mesh`, keeps each rank's slice of every parameter
(:func:`shard_model`, or :func:`sharded_init` while the seeded init draws
them) and calls the collectives itself where the reference calls
``constrain``:

* :func:`reduce_model`: ``all_reduce`` (sum) over the mesh's ``model``
  group, after a row-parallel projection (``wo``, ``wd``: the f32 partial
  sums, before their cast to the activation dtype, ``core/dense.py``)
  and after the vocab-parallel embedding lookup;
* :func:`copy_model`: the identity where a replicated activation enters
  column-parallel weights (``wq``/``wk``/``wv``, ``wg``/``wu``, the
  experts' up projections, the vocab-parallel head), whose gradient is
  summed over ``model`` in a backward pass: with :func:`reduce_model`
  (the identity in a backward pass) Megatron's pair;
* :func:`gather_model`: ``all_gather`` and ``cat``, for the
  column-parallel head's logits along V, so that every rank holds all of
  them and picks the same token (in a backward pass each rank keeps its
  block of the gradient);
* :func:`gather_model_summed`: the same gather where each rank's
  consumers differ (every SSD head reads the whole of the Mamba2 block's
  B and C): in a backward pass the ranks' gradients are summed and each
  keeps its block;
* :func:`model_block`: this rank's block of a replicated activation, for
  a row-parallel weight that reads one (the hybrid's ``shared/out_proj``
  over the 2d-wide concat), whose gradient the ranks' blocks gather into
  the whole.

All are the identity with no mesh (:func:`use_mesh`), so a path run
without one is what it was, and with no gradient each is the serving
path's call.  A replicated weight that reads the same activation (the
router, the norms) sits outside :func:`copy_model`, so that its input's
gradient is not summed tp times; a ``wk``/``wv`` whose kv heads more than
one rank holds gets its gradient summed over them (:func:`sum_partial`,
which the training step calls).  The training step's data axis:
:func:`data_sum` (the loss's label count over the global batch),
:func:`data_offsets` (a MoE expert's capacity ranks over the global
batch), :class:`LeafLayout` (what each rank keeps of a parameter).  The
rules are the reference's, copied (``_PARAM_RULES``, ``_PARAM_RULES_EP``,
:func:`spec_for_param`, :func:`sanitize`, :func:`paged_pool_spec`'s
choice) and matched against ``core/prequant.py::param_path`` names:
Megatron-style column-parallel in-projections, row-parallel
out-projections, vocab-parallel embeddings, TP inside each expert.  A
rule whose dimension does not divide the ``model`` axis keeps the
parameter whole (granite's vocab of 49,155 at tp = 2).

The Mamba2 mixer's ``in_proj`` packs five blocks of columns (z, x, B, C,
dt); the reference's column rule cuts it blindly, the port cuts each
block by tp (z, x and dt by SSD heads, B and C by state channels), the
same (2 di + 2 ds + nh) / tp columns a rank.  The mixer's other leaves
(``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``, the gated norm's
scale) match no rule: whole on every rank, as the reference keeps them
on every device, each rank reading its channels' or heads' slice and
their gradients summed over ``model`` (``partial``).

The encoder-decoder's cross-attention (``xattn``) is cut as
self-attention is: ``wq`` by q heads, ``wk``/``wv`` by
:func:`kv_heads_for_rank`, ``wo`` row-parallel.  Its ``frontend_proj``
matches no rule and stays whole on every rank, as in the reference.

One layout differs (:func:`kv_heads_for_rank`).  Where the kv heads do
not divide the model axis, the reference shards the paged pool on
positions (``seq_tp``) and lets GSPMD partition its gather path.  The
port keeps on each rank the kv heads its q heads read (kv head = q head
// (H / kv)), those ``wk``/``wv`` columns replicated, so that K2 runs on a
local pool with no cross-rank softmax: the same math, a pool tp / kv
times larger.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import re
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

# logical -> physical mesh axes
_LOGICAL = {
    "batch": ("pod", "data"),  # gradient/data parallel (pod folds into DP)
    "model": ("model",),       # tensor/expert parallel
    "seq": ("data",),          # sequence parallel (long-context KV)
    "seq_tp": ("model",),      # KV-cache seq sharded over TP axis (GQA kv < tp)
    None: None,
}


class Mesh:
    """The stand-in of the reference's ``jax.sharding.Mesh`` over
    ``torch.distributed`` ranks: this process's ``rank`` in a world of
    ``data`` x ``model`` ranks, with the reference's ``axis_names`` and
    ``shape`` (all that :func:`sanitize` reads) and the world's
    ``backend``.  Rank ``r`` sits at ``(r // model, r % model)``, so the
    ranks of one ``model`` group are neighbours (adjacent cards).
    ``groups`` holds the process group of this rank's ``model`` and
    ``data`` axes (``launch/mesh.py::make_host_mesh`` makes them); an axis
    without one is the whole world, the default group.

    The collectives count their calls and result bytes, as the
    reference's HLO accounting counts them, in ``traffic`` (``"<axis>/
    <kind>"`` -> [calls, bytes], the kinds the HLO's: ``all-reduce``,
    ``all-gather``), which ``collectives`` reads back as calls alone;
    each is also told to ``collective_listeners`` (the op analysis).  With ``time_collectives`` set they also add their host
    seconds, the card synchronized on both sides, to ``collective_s``.
    Under ``gloo``, which moves host tensors, a CUDA tensor crosses
    through host memory, bf16 as f32 in a sum and as its two-byte bits (a
    float16 view) in a gather (all exact).

    ``batch_axis`` names the axis that the global batch is split over:
    ``data`` here (``launch/mesh.py::VirtualMesh`` folds a ``pod`` axis
    into it, as the reference's logical ``batch`` does)."""

    axis_names = ("data", "model")
    batch_axis = "data"

    def __init__(self, rank: int, model: int, backend: str = "gloo", data: int = 1,
                 groups: Optional[Dict[str, object]] = None):
        if not 0 <= rank < data * model:
            raise ValueError(f"rank {rank} outside a mesh of {data} x {model}")
        self.rank = rank
        self.backend = backend
        self.shape = {"data": data, "model": model}
        self.groups = dict(groups or {})
        self.traffic: Dict[str, List[int]] = {}
        self.collective_s = 0.0
        self.time_collectives = False

    @property
    def collectives(self) -> Dict[str, int]:
        """The calls of ``traffic`` (read only: clear ``traffic``), the
        ``model`` axis' as ``all_reduce`` and ``all_gather``, the others'
        as ``"<axis>_<kind>"``."""
        out = {}
        for name, (calls, _) in self.traffic.items():
            axis, kind = name.split("/")
            kind = kind.replace("-", "_")
            out[kind if axis == "model" else f"{axis}_{kind}"] = calls
        return out

    @property
    def model_rank(self) -> int:
        return self.rank % self.shape["model"]

    @property
    def model_size(self) -> int:
        return self.shape["model"]

    @property
    def data_rank(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def data_size(self) -> int:
        return self.shape["data"]

    @property
    def batch_rank(self) -> int:
        """This rank's index over the batch axis."""
        return self.data_rank

    @property
    def batch_size(self) -> int:
        return self.axis_size(self.batch_axis)

    @property
    def world_size(self) -> int:
        return self.data_size * self.model_size

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, shape={self.shape}, "
                f"backend={self.backend!r})")

    def _wire(self, x: torch.Tensor, sum_: bool = True) -> torch.Tensor:
        """A copy of x as it crosses the wire (``sum_``: to be added)."""
        if self.backend == "gloo":
            if x.dtype == torch.bfloat16:
                if sum_:
                    return x.detach().to("cpu", torch.float32, copy=True).contiguous()
                return x.detach().contiguous().view(torch.float16).to("cpu", copy=True)
            return x.detach().to("cpu", copy=True).contiguous()
        return x.detach().clone(memory_format=torch.contiguous_format)

    @staticmethod
    def _unwire(part: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """A gathered ``part`` back in x's dtype (a bf16 crossed as its bits)."""
        return part.view(torch.bfloat16) if x.dtype == torch.bfloat16 else part

    def _sync(self, x: torch.Tensor) -> None:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    def _note(self, axis: str, kind: str, x: torch.Tensor) -> None:
        """Count one collective over ``axis`` of x: its call and its result
        bytes (an all-gather's the gathered whole)."""
        hlo = {"all_reduce": "all-reduce", "all_gather": "all-gather"}.get(kind, kind)
        n = self.world_size if axis == "world" else self.axis_size(axis)
        nbytes = x.numel() * x.element_size() * (n if kind in ("all_gather", "gather") else 1)
        tally = self.traffic.setdefault(f"{axis}/{hlo}", [0, 0])
        tally[0] += 1
        tally[1] += nbytes
        for fn in collective_listeners:
            fn(hlo, axis, n, nbytes)

    @contextlib.contextmanager
    def _call(self, axis: str, kind: str, x: torch.Tensor):
        """Count (and with ``time_collectives`` time) one collective."""
        self._note(axis, kind, x)
        if not self.time_collectives:
            yield
            return
        self._sync(x)
        t0 = time.perf_counter()
        yield
        self._sync(x)
        self.collective_s += time.perf_counter() - t0

    def all_reduce(self, x: torch.Tensor, axis: str = "model", op: str = "sum") -> torch.Tensor:
        """The sum (or ``op="max"``: the largest) of x over ``axis``, on
        every rank of it."""
        import torch.distributed as dist

        with self._call(axis, "all_reduce", x):
            buf = self._wire(x)
            dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                            group=self.groups.get(axis))
            out = buf.to(x.device, x.dtype)
        return out

    def all_gather(self, x: torch.Tensor, axis: str = "model") -> List[torch.Tensor]:
        """Every rank's x over ``axis``, in the axis' rank order, on every
        rank of it."""
        import torch.distributed as dist

        with self._call(axis, "all_gather", x):
            buf = self._wire(x, sum_=False)
            parts = [torch.empty_like(buf) for _ in range(self.shape[axis])]
            dist.all_gather(parts, buf, group=self.groups.get(axis))
            out = [self._unwire(p, x).to(x.device) for p in parts]
        return out

    def gather_to_first(self, x: torch.Tensor, axis: Optional[str] = None
                        ) -> Optional[List[torch.Tensor]]:
        """Every rank's x (on the host) at the first rank of ``axis`` (the
        whole world with None), in rank order; None on the other ranks.
        The checkpoints' path: one rank holds the whole leaf."""
        import torch.distributed as dist

        group = None if axis is None else self.groups.get(axis)
        n = self.world_size if axis is None else self.axis_size(axis)
        first = 0 if axis is None else (self.rank - self.model_rank if axis == "model"
                                        else self.model_rank)
        with self._call(axis or "world", "gather", x):
            buf = self._wire(x, sum_=False)
            parts = [torch.empty_like(buf) for _ in range(n)] if self.rank == first else None
            dist.gather(buf, parts, dst=first, group=group)
        return None if parts is None else [self._unwire(p, x).cpu() for p in parts]

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier()


#: functions told of each collective a mesh runs: (the HLO kind, the axis,
#: the group's size, the result bytes) (``launch/op_analysis.py``)
collective_listeners: List = []

_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the current mesh inside the block (None: no mesh).
    The mesh is a context variable, which the autograd engine's device
    threads do not inherit: a function that a backward pass runs again
    (``torch.utils.checkpoint``) enters the mesh itself."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def current_mesh() -> Optional[Mesh]:
    return _MESH.get()


# The Megatron pair (and the head's gather) as autograd Functions, for the
# training step: a replicated activation enters the column-parallel weights
# through _Copy (its gradient, partial on each rank, summed in the backward);
# the row-parallel partial sums leave through _Reduce (summed in the forward,
# the gradient passed on as it is).  Each keeps its mesh for the backward,
# which a device thread runs outside the caller's context.


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.slice = (dim, mesh.model_rank * x.shape[dim], x.shape[dim])
        return torch.cat(mesh.all_gather(x), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(*ctx.slice), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh = mesh
        ctx.slice = (dim, mesh.model_rank * x.shape[dim], x.shape[dim])
        return torch.cat(mesh.all_gather(x), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g).narrow(*ctx.slice), None, None


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n = x.shape[dim] // mesh.model_size
        return x.narrow(dim, mesh.model_rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.mesh.all_gather(g.contiguous()), dim=ctx.dim), None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce_model(x: torch.Tensor) -> torch.Tensor:
    """Sum x over the current mesh's model axis (in a backward pass the
    identity); the identity with no mesh."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    return _Reduce.apply(x, mesh) if _tracked(x) else mesh.all_reduce(x)


def copy_model(x: torch.Tensor) -> torch.Tensor:
    """x as it enters this rank's column-parallel weights: the identity,
    whose gradient is summed over the model axis in a backward pass (each
    rank's is the part its columns give).  The identity with no mesh or
    no gradient."""
    mesh = _MESH.get()
    return _Copy.apply(x, mesh) if mesh is not None and _tracked(x) else x


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Concatenate the model axis' blocks of x along ``dim``, in rank order
    (in a backward pass each rank takes its block of the gradient); the
    identity with no mesh."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    if _tracked(x):
        return _Gather.apply(x, mesh, dim % x.dim())
    return torch.cat(mesh.all_gather(x), dim=dim)


def gather_model_summed(x: torch.Tensor, dim: int) -> torch.Tensor:
    """:func:`gather_model` for blocks that every rank reads in its own way
    (each rank's SSD heads read the whole of B and C): in a backward pass
    the ranks' gradients of the whole are summed over the model axis and
    each keeps its block.  The identity with no mesh."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    if _tracked(x):
        return _GatherSum.apply(x, mesh, dim % x.dim())
    return torch.cat(mesh.all_gather(x), dim=dim)


def model_block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's block of a replicated x along ``dim`` (the input
    of a row-parallel weight that reads a replicated activation); in a
    backward pass the ranks' block gradients are gathered into the whole
    one.  The identity with no mesh."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    if _tracked(x):
        return _Block.apply(x, mesh, dim % x.dim())
    n = x.shape[dim] // mesh.model_size
    return x.narrow(dim, mesh.model_rank * n, n)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """x (no gradient) summed over the current mesh's batch axis: a count
    of the global batch from each data rank's rows.  The identity with no
    mesh or one data rank."""
    mesh = _MESH.get()
    if mesh is None or mesh.batch_size == 1:
        return x
    return mesh.all_reduce(x.detach(), axis=mesh.batch_axis)


def data_offsets(counts: torch.Tensor) -> torch.Tensor:
    """The sum of ``counts`` over the data ranks before this one (zeros with
    no mesh or one data rank): where this rank's rows start in a count
    that runs over the global batch, such as a MoE expert's capacity."""
    mesh = _MESH.get()
    if mesh is None or mesh.batch_size == 1:
        return torch.zeros_like(counts)
    parts = mesh.all_gather(counts, mesh.batch_axis)
    return sum(parts[:mesh.batch_rank], torch.zeros_like(counts))


def _resolve(mesh: Mesh, logical):
    """Logical axis -> physical axes present in this mesh (or None)."""
    if logical is None:
        return None
    phys = [a for a in _LOGICAL[logical] if a in mesh.axis_names]
    if not phys:
        return None
    return tuple(phys) if len(phys) > 1 else phys[0]


# ---------------------------------------------------------------------------
# parameter sharding rules (matched against '/'-joined parameter paths)
# ---------------------------------------------------------------------------
# Megatron-style TP: column-parallel in-projections, row-parallel
# out-projections; vocab-parallel embeddings; expert-parallel MoE.
_PARAM_RULES = [
    (r"unembed$", (None, "model")),             # [d, V]
    (r"(^|/)embed$", ("model", None)),          # [V, d] vocab-parallel
    (r"(wq|wk|wv)$", (None, "model")),          # column parallel
    (r"wo$", ("model", None)),                  # row parallel
    (r"(wu|wg)$", (None, "model")),             # MLP up/gate: column
    (r"wd$", ("model", None)),                  # MLP down: row
    (r"moe/(wu|wg)$", (None, None, "model")),   # [E, d, ff]: TP inside expert
    (r"moe/wd$", (None, "model", None)),
    (r"moe/router$", (None, None)),
    (r"in_proj$", (None, "model")),             # mamba in: column
    (r"out_proj$", ("model", None)),            # mamba out: row
]
# MoE expert-parallel alternative (E over model axis) is selected by
# rule-set name; see expert_parallel_rules().
_PARAM_RULES_EP = [
    (r"moe/(wu|wg)$", ("model", None, None)),   # [E, d, ff]: experts sharded
    (r"moe/wd$", ("model", None, None)),
] + _PARAM_RULES


def spec_for_param(path: str, ndim: int, rules=None) -> tuple:
    for pat, dims in (rules or _PARAM_RULES):
        if re.search(pat, path):
            if len(dims) < ndim:  # stacked-layer leading axes -> replicated
                dims = (None,) * (ndim - len(dims)) + tuple(dims)
            return dims
    return (None,) * ndim


def _axis_size(mesh: Mesh, phys) -> int:
    if phys is None:
        return 1
    if isinstance(phys, tuple):
        out = 1
        for a in phys:
            out *= mesh.shape[a]
        return out
    return mesh.shape[phys]


def sanitize(mesh: Mesh, dims, shape):
    """Drop shardings whose dimension size is not divisible (e.g. a
    49155-entry vocab over a 16-way model axis, or batch 1 over data)."""
    out = []
    for i, d in enumerate(dims):
        phys = _resolve(mesh, d)
        if phys is not None and shape[i] % _axis_size(mesh, phys) != 0:
            d = None
        out.append(d)
    return tuple(out)


def expert_parallel_rules():
    return _PARAM_RULES_EP


def paged_pool_spec(mesh: Mesh, shape) -> tuple:
    """The reference's logical dims of a paged KV pool [L, num_blocks,
    block_size, kv, hd]: ``model`` on the kv-head axis where the kv heads
    divide it, else ``seq_tp`` on the positions within a block, else
    replicated.  The port follows the first choice; in place of the
    second it keeps the replicated kv heads of :func:`kv_heads_for_rank`
    (``pool_layout``)."""
    dims = sanitize(mesh, (None, None, None, "model", None), shape)
    if dims[3] is None:
        dims = sanitize(mesh, (None, None, "seq_tp", None, None), shape)
    return dims


def pool_layout(mesh: Mesh, shape) -> str:
    """``"kv_heads"`` (the pool's kv heads cut over the ranks) or
    ``"replicated_kv_heads"`` (each rank the kv heads its q heads read)."""
    return "kv_heads" if paged_pool_spec(mesh, shape)[3] == "model" else "replicated_kv_heads"


# ---------------------------------------------------------------------------
# the port's layout: each rank's slice of each parameter
# ---------------------------------------------------------------------------


def kv_heads_for_rank(n_heads: int, n_kv: int, tp: int, rank: int) -> List[int]:
    """The kv heads rank ``rank`` of ``tp`` keeps, for its q heads
    ``[rank * H / tp, (rank + 1) * H / tp)`` (GQA: q head j reads kv head
    j // (H / kv)).  Where kv divides tp this is the rank's block of
    kv / tp heads, the reference's layout; otherwise each distinct kv head
    its q heads read, once, when they read them equally often (tp a
    multiple of kv: one head), else one kv head a q head."""
    if n_heads % tp:
        raise ValueError(f"{n_heads} q heads do not divide tp={tp}")
    local = n_heads // tp
    kvs = [q * n_kv // n_heads for q in range(rank * local, (rank + 1) * local)]
    uniq = sorted(set(kvs))
    if all(kvs.count(k) == local // len(uniq) for k in uniq) and local % len(uniq) == 0:
        return uniq
    return kvs


def check_shardable(cfg, tp: int) -> None:
    """Raise unless ``cfg`` can be cut ``tp`` ways: a dense, MoE or vlm
    transformer (the vlm is the dense LM with M-RoPE) or an encoder-decoder
    whose q heads divide tp; a Mamba2 LM whose SSD heads and state
    channels divide it; a hybrid whose shared attention's q heads divide
    it too."""
    if cfg.family not in ("dense", "moe", "vlm", "encdec", "ssm", "hybrid"):
        raise ValueError(f"tensor parallelism has no rules for the {cfg.family!r} family")
    if cfg.family in ("ssm", "hybrid"):
        nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        for what, n in (("SSD heads", nh), ("SSM state channels", cfg.ssm_state)):
            if n % tp:
                raise ValueError(f"{cfg.name}: {n} {what} do not divide tp={tp}")
        if cfg.family == "ssm":
            return
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} q heads do not divide tp={tp}")


#: the kv projections, self-attention's and the decoder's cross-attention's
_KV_COLUMNS = re.compile(r"(^|/)x?attn/w[kv]$")
#: row-parallel leaves; out_proj's mark is also what sends a Mamba2 mixer
#: down its mesh path (:func:`_mark`, ``models/ssm.py::mamba2_apply``)
_ROW = re.compile(r"(^|/)(wo|wd|out_proj)$")
_VOCAB = re.compile(r"(^|/)(un)?embed$")
#: the Mamba2 mixer's in_proj, cut block by block (:func:`ssm_in_columns`)
_SSM_IN = re.compile(r"(^|/)mamba/in_proj$")
#: the mixer's leaves that no rule cuts: whole on every rank, each rank
#: reading its channels or heads (``models/ssm.py::mamba2_apply``), their
#: gradients summed over ``model``
_SSM_WHOLE = re.compile(r"(^|/)mamba/(conv_w|conv_b|A_log|D|dt_bias|norm/scale)$")


def head_dim_of(cfg, path: str) -> int:
    """The head dim of the attention that owns ``path``: the hybrid's
    shared block attends over 2 d_model with heads of 2 d_model / H."""
    return 2 * cfg.d_model // cfg.n_heads if path.startswith("shared/") else cfg.hd


def ssm_in_columns(cfg, tp: int, rank: int) -> List[int]:
    """The columns of ``in_proj`` [d, 2 di + 2 ds + nh] (z, x, B, C, dt)
    that model rank ``rank`` of ``tp`` keeps: its block of each, z, x and
    dt by SSD heads and B and C by state channels, in that order."""
    di = cfg.ssm_expand * cfg.d_model
    ds, nh = cfg.ssm_state, di // cfg.ssm_head_dim
    out = []
    for start, width in ((0, di), (di, di), (2 * di, ds), (2 * di + ds, ds),
                         (2 * di + 2 * ds, nh)):
        n = width // tp
        out.extend(range(start + rank * n, start + (rank + 1) * n))
    return out


def _keep(path: str, shape, cfg, mesh: Mesh, rank: int):
    """(dim, the entries of it that model rank ``rank`` keeps) of parameter
    ``path`` of whole ``shape``: a ``range`` (a block of the dim its rule
    names, where ``sanitize`` keeps the rule), a list of columns
    (``wk``/``wv``: the kv heads of :func:`kv_heads_for_rank`), or
    (None, None) where the parameter stays whole."""
    tp = mesh.model_size
    if _KV_COLUMNS.search(path):
        heads = kv_heads_for_rank(cfg.n_heads, cfg.n_kv, tp, rank)
        if heads == list(range(cfg.n_kv)):
            return None, None
        hd = head_dim_of(cfg, path)
        return len(shape) - 1, [h * hd + j for h in heads for j in range(hd)]
    dims = sanitize(mesh, spec_for_param(path, len(shape)), tuple(shape))
    if _SSM_IN.search(path) and dims[-1] == "model":
        return len(shape) - 1, ssm_in_columns(cfg, tp, rank)
    for d, logical in enumerate(dims):
        if _resolve(mesh, logical) == "model":
            n = shape[d] // tp
            return d, range(rank * n, (rank + 1) * n)
    return None, None


def _take(t, dim: int, keep):
    """t's entries ``keep`` along ``dim`` (a torch tensor or numpy array)."""
    if isinstance(keep, range):
        return t.narrow(dim, keep.start, len(keep)) if torch.is_tensor(t) else \
            t[(slice(None),) * dim + (slice(keep.start, keep.stop),)]
    if torch.is_tensor(t):
        return t.index_select(dim, torch.tensor(keep, device=t.device))
    return t.take(keep, axis=dim)


def shard_tensor(path: str, t: torch.Tensor, cfg, mesh: Mesh
                 ) -> Tuple[torch.Tensor, Optional[int]]:
    """(this rank's slice of parameter ``path``, the dim it was cut on, or
    None where the parameter stays whole).  ``wk``/``wv`` keep the
    columns of :func:`kv_heads_for_rank`'s heads; every other parameter
    its block of the dim its rule names, where ``sanitize`` keeps it."""
    dim, keep = _keep(path, t.shape, cfg, mesh, mesh.model_rank)
    if dim is None:
        return t, None
    if isinstance(keep, range) and mesh.model_size == 1:  # a mesh of one: whole, marked cut
        return t, dim
    return _take(t, dim, keep).clone(), dim


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """One parameter of a model cut for a mesh, as the training step sees
    it: its name, the reference's ``path``, its ``layer`` (None outside the
    layer stacks), its whole ``shape``, the ``dim`` it is cut on (None:
    whole on every rank) and each model rank's entries of it (``keeps``,
    :func:`_keep`'s).  ``partial``: a ``wk``/``wv`` whose kv heads more
    than one rank holds (kv < tp, or kv = 1), so that each rank's gradient
    is the part its q heads give, to be summed over the ranks that hold
    the head (:func:`sum_partial`)."""

    name: str
    path: str
    layer: Optional[int]
    shape: Tuple[int, ...]
    dim: Optional[int]
    keeps: Tuple
    partial: bool

    def keep(self, rank: int):
        return self.keeps[rank]

    def local(self, whole, rank: int):
        """Model rank ``rank``'s slice of the whole leaf (tensor or array)."""
        return whole if self.dim is None else _take(whole, self.dim, self.keeps[rank])

    def whole(self, pieces: List[torch.Tensor], lead: int = 0) -> torch.Tensor:
        """The whole leaf from every model rank's slice, in rank order (with
        ``lead`` leading axes, such as a stack of layers, before it)."""
        if self.dim is None:
            return pieces[0]
        d = self.dim + lead
        if isinstance(self.keeps[0], range):
            return torch.cat(pieces, dim=d)
        shape = pieces[0].shape[:d] + (self.shape[self.dim],) + pieces[0].shape[d + 1:]
        out = pieces[0].new_zeros(shape)
        for piece, keep in zip(pieces, self.keeps):
            out.index_copy_(d, torch.tensor(keep), piece)
        return out


@functools.lru_cache(maxsize=64)
def meta_params(cfg) -> Tuple[Tuple[str, Tuple[int, ...], torch.dtype], ...]:
    """(name, shape, dtype) of every parameter of the whole model of
    ``cfg`` (a ``meta`` init, once a config)."""
    from repro_torch.models.registry import build

    return tuple((n, tuple(p.shape), p.dtype)
                 for n, p in build(cfg).init(device="meta").named_parameters())


def leaf_layouts(cfg, mesh: Mesh) -> Dict[str, LeafLayout]:
    """Every parameter's :class:`LeafLayout` under ``mesh``, by name, from
    the whole model's shapes (:func:`meta_params`)."""
    from repro_torch.core.prequant import layer_index, param_path

    check_shardable(cfg, mesh.model_size)
    tp = mesh.model_size
    out = {}
    for name, shape, _ in meta_params(cfg):
        path = param_path(name)
        keeps = [_keep(path, shape, cfg, mesh, r) for r in range(tp)]
        dim = keeps[0][0]
        partial = bool(_SSM_WHOLE.search(path)) and tp > 1
        if _KV_COLUMNS.search(path) and tp > 1:
            held = sum(shape[-1] if k is None else len(k) for _, k in keeps)
            partial = held > shape[-1]
        out[name] = LeafLayout(name, path, layer_index(name), shape, dim,
                               tuple(k for _, k in keeps), partial)
    return out


def sum_partial(g: torch.Tensor, lay: LeafLayout, mesh: Mesh) -> torch.Tensor:
    """The whole gradient of a ``partial`` leaf from each rank's part: the
    rank's columns added into the whole leaf (a column a rank holds twice,
    twice), summed over the model axis."""
    if lay.dim is None:
        return mesh.all_reduce(g)
    keep = torch.tensor(lay.keep(mesh.model_rank), device=g.device)
    whole = g.new_zeros(lay.shape).index_add_(lay.dim, keep, g)
    return mesh.all_reduce(whole)


def _mark(owner: nn.Module, path: str, dim: int, ndim: int) -> None:
    """Record on the module what its cut parameter asks of the forward:
    ``row_parallel`` (a K block of wo / wd / out_proj: sum the partials;
    on a Mamba2 mixer, whose in_proj is cut with it, the mark of a cut
    mixer) or ``vocab_parallel`` (a V block of embed / unembed)."""
    if _ROW.search(path) and dim == ndim - 2:
        owner.row_parallel = True
    elif _VOCAB.search(path):
        owner.vocab_parallel = True


@torch.no_grad()
def shard_model(model: nn.Module, cfg, mesh: Optional[Mesh]) -> nn.Module:
    """Keep this rank's slice of every parameter of ``model`` (a dense,
    MoE, vlm, Mamba2, hybrid or encoder-decoder LM), in place: a column
    rule its N block, a row rule its K block, ``embed`` its vocab block;
    ``wk``/``wv`` the columns of :func:`kv_heads_for_rank`; a Mamba2
    ``in_proj`` those of :func:`ssm_in_columns`.  Float weights and posit patterns alike.
    The identity with no mesh and on a model already cut for this mesh
    (``tp_shard``).  A mesh of one rank cuts nothing but marks what it
    would cut, so that its forward runs every collective (a world of
    one, each an identity)."""
    if mesh is None:
        return model
    key = (mesh.model_rank, mesh.model_size)
    done = getattr(model, "tp_shard", None)
    if done == key:
        return model
    if done is not None:
        raise ValueError(f"the model is cut for rank/size {done}, not {key}")
    from repro_torch.core.prequant import param_path

    check_shardable(cfg, mesh.model_size)
    for name in [n for n, _ in model.named_parameters()]:
        mod_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(mod_name) if mod_name else model
        full = getattr(owner, attr)
        path = param_path(name)
        part, dim = shard_tensor(path, full.data, cfg, mesh)
        if dim is not None:
            setattr(owner, attr, nn.Parameter(part, requires_grad=False))
            _mark(owner, path, dim, full.dim())
        del full, part
    model.tp_shard = key
    return model


#: the path prefix of each parameter-owning module of a transformer LM, as
#: its parameters' ``param_path`` names begin (a MoE's shared experts are
#: an MLP: the rules give them the MLP's layout, as they do the reference's
#: ``moe/shared/*``)
_INIT_PREFIX = {"DenseLM": "", "Attention": "layers/attn/", "MLP": "layers/mlp/",
                "MoE": "layers/moe/", "RMSNorm": "layers/ln/"}


@contextlib.contextmanager
def sharded_init(cfg, mesh: Optional[Mesh]):
    """While a transformer LM (``DenseLM``; the Mamba2 and hybrid LMs are
    drawn whole and cut by :func:`shard_model`) is built inside the block,
    cut each parameter to this rank's slice as soon as it is drawn
    (``nn.Module``'s parameter registration hook), so that a rank holds
    its shard and one full tensor at most; the draws, and so the values,
    are the unsharded init's.  The result equals :func:`shard_model` of
    the whole model.  Nothing changes with no mesh."""
    if mesh is None:
        yield
        return
    check_shardable(cfg, mesh.model_size)

    def cut(module, name, param):
        if param is None:
            return None
        path = _INIT_PREFIX[type(module).__name__] + name
        part, dim = shard_tensor(path, param.data, cfg, mesh)
        if dim is None:
            return None
        _mark(module, path, dim, param.dim())
        return nn.Parameter(part, requires_grad=param.requires_grad)

    handle = nn.modules.module.register_module_parameter_registration_hook(cut)
    try:
        yield
    finally:
        handle.remove()
