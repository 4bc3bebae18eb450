"""Tensor-parallel sharding rules and collectives (port of
``repro/parallel/sharding.py``).

The reference names logical axes and lets GSPMD place its arrays.  The
port runs one process a rank (``launch/mesh.py``), keeps each rank's
slice of every parameter (:func:`shard_model`, or :func:`sharded_init`
while the seeded init draws them) and calls the collectives itself where
the reference calls ``constrain``:

* :func:`reduce_model`: ``all_reduce`` (sum) over the mesh's ``model``
  group, after a row-parallel projection (``wo``, ``wd``: the f32 partial
  sums, before their cast to the activation dtype, ``core/dense.py``)
  and after the vocab-parallel embedding lookup;
* :func:`gather_model`: ``all_gather`` and ``cat``, for the
  column-parallel head's logits along V, so that every rank holds all of
  them and picks the same token.

Both are the identity with no mesh (:func:`use_mesh`), so a path run
without one is what it was.  The rules are the reference's, copied
(``_PARAM_RULES``, ``_PARAM_RULES_EP``, :func:`spec_for_param`,
:func:`sanitize`, :func:`paged_pool_spec`'s choice) and matched against
``core/prequant.py::param_path`` names: Megatron-style column-parallel
in-projections, row-parallel out-projections, vocab-parallel embeddings,
TP inside each expert.  A rule whose dimension does not divide the
``model`` axis keeps the parameter whole (granite's vocab of 49,155 at
tp = 2).

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
import re
import time
from typing import List, Optional, Tuple

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
    ``model`` ranks (the default group: the ``data`` axis is 1, data
    parallelism coming with the training side, ``ROADMAP.md``, queue 1,
    item 8) and the group's ``backend``, with the reference's
    ``axis_names`` and ``shape`` (all that :func:`sanitize` reads).

    The collectives count their calls in ``collectives``; with
    ``time_collectives`` set they also add their host seconds, the card
    synchronized on both sides, to ``collective_s``.  Under ``gloo``,
    which moves host tensors, a CUDA tensor crosses through host memory
    and bf16 as f32 (both exact)."""

    axis_names = ("data", "model")

    def __init__(self, rank: int, model: int, backend: str = "gloo"):
        if not 0 <= rank < model:
            raise ValueError(f"rank {rank} outside a model axis of {model}")
        self.rank = rank
        self.backend = backend
        self.shape = {"data": 1, "model": model}
        self.collectives = {"all_reduce": 0, "all_gather": 0}
        self.collective_s = 0.0
        self.time_collectives = False

    @property
    def model_rank(self) -> int:
        return self.rank

    @property
    def model_size(self) -> int:
        return self.shape["model"]

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, shape={self.shape}, "
                f"backend={self.backend!r})")

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """A copy of x as it crosses the wire."""
        if self.backend == "gloo":
            dt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
            return x.detach().to("cpu", dt, copy=True).contiguous()
        return x.detach().clone(memory_format=torch.contiguous_format)

    def _sync(self, x: torch.Tensor) -> None:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the model axis, on every rank."""
        import torch.distributed as dist

        self.collectives["all_reduce"] += 1
        if self.time_collectives:
            self._sync(x)
            t0 = time.perf_counter()
        buf = self._wire(x)
        dist.all_reduce(buf)
        out = buf.to(x.device, x.dtype)
        if self.time_collectives:
            self._sync(out)
            self.collective_s += time.perf_counter() - t0
        return out

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's x, in rank order, on every rank."""
        import torch.distributed as dist

        self.collectives["all_gather"] += 1
        if self.time_collectives:
            self._sync(x)
            t0 = time.perf_counter()
        buf = self._wire(x)
        parts = [torch.empty_like(buf) for _ in range(self.model_size)]
        dist.all_gather(parts, buf)
        out = [p.to(x.device, x.dtype) for p in parts]
        if self.time_collectives:
            self._sync(out[0])
            self.collective_s += time.perf_counter() - t0
        return out


_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the current mesh inside the block (None: no mesh)."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def current_mesh() -> Optional[Mesh]:
    return _MESH.get()


def reduce_model(x: torch.Tensor) -> torch.Tensor:
    """Sum x over the current mesh's model axis; the identity with no mesh."""
    mesh = _MESH.get()
    return x if mesh is None else mesh.all_reduce(x)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Concatenate the model axis' blocks of x along ``dim``, in rank order;
    the identity with no mesh."""
    mesh = _MESH.get()
    return x if mesh is None else torch.cat(mesh.all_gather(x), dim=dim)


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
    """Raise unless ``cfg`` can be cut ``tp`` ways: a dense or MoE
    transformer whose q heads divide tp."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"tensor parallelism serves the dense and moe families, "
                         f"not {cfg.family!r}")
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} q heads do not divide tp={tp}")


_KV_COLUMNS = re.compile(r"(^|/)attn/w[kv]$")
_ROW = re.compile(r"(^|/)(wo|wd)$")
_VOCAB = re.compile(r"(^|/)(un)?embed$")


def shard_tensor(path: str, t: torch.Tensor, cfg, mesh: Mesh
                 ) -> Tuple[torch.Tensor, Optional[int]]:
    """(this rank's slice of parameter ``path``, the dim it was cut on, or
    None where the parameter stays whole).  ``wk``/``wv`` keep the
    columns of :func:`kv_heads_for_rank`'s heads; every other parameter
    its block of the dim its rule names, where ``sanitize`` keeps it."""
    tp, rank = mesh.model_size, mesh.model_rank
    if _KV_COLUMNS.search(path):
        heads = kv_heads_for_rank(cfg.n_heads, cfg.n_kv, tp, rank)
        if heads == list(range(cfg.n_kv)):
            return t, None
        hd, last = cfg.hd, t.dim() - 1
        cols = torch.tensor([h * hd + j for h in heads for j in range(hd)], device=t.device)
        return t.index_select(last, cols), last
    dims = sanitize(mesh, spec_for_param(path, t.dim()), t.shape)
    for d, logical in enumerate(dims):
        if _resolve(mesh, logical) == "model":
            if tp == 1:  # a mesh of one: whole, and marked as cut
                return t, d
            n = t.shape[d] // tp
            return t.narrow(d, rank * n, n).clone(), d
    return t, None


def _mark(owner: nn.Module, path: str, dim: int, ndim: int) -> None:
    """Record on the module what its cut parameter asks of the forward:
    ``row_parallel`` (a K block of wo / wd: sum the partials) or
    ``vocab_parallel`` (a V block of embed / unembed)."""
    if _ROW.search(path) and dim == ndim - 2:
        owner.row_parallel = True
    elif _VOCAB.search(path):
        owner.vocab_parallel = True


@torch.no_grad()
def shard_model(model: nn.Module, cfg, mesh: Optional[Mesh]) -> nn.Module:
    """Keep this rank's slice of every parameter of a dense or MoE
    ``model``, in place: a column rule its N block, a row rule its K
    block, ``embed`` its vocab block; ``wk``/``wv`` the columns of
    :func:`kv_heads_for_rank`.  Float weights and posit patterns alike.
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
    """While a transformer LM is built inside the block, cut each
    parameter to this rank's slice as soon as it is drawn
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
