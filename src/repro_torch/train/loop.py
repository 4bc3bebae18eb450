"""Training loop (port of ``repro/train/loop.py``): the step (gradients and
the optimizer), gradient accumulation, optional int8 gradient
compression, checkpoint/restart and failure recovery.

Parameters are an ``nn.Module`` (its float parameters are what trains;
make them trainable with ``models.transformer.set_trainable``) or a dict
of tensors.  The step updates them in place.  A parameter that no
gradient reaches (the products of ``plam_sim`` and ``mitchell_f32`` go
through integer patterns, as in the reference, where their gradient is
exactly zero) gets a zero gradient.

``_int8_compress`` draws its rounding noise from a ``torch.Generator``
seeded from (17, step), not from JAX's threefry: the same distribution,
other bits.

Under a mesh of ranks (``zero``, an ``optim.optimizers.Zero1``, whose
``mesh`` the step runs in) the step is the one-rank step over the
ranks: each data rank takes its rows of the global batch (of each
micro-batch), the loss's count of labels is the global batch's
(``models/transformer.py::lm_loss_chunked``), the gradients are summed
over ``data`` in f32 leaf by leaf and, for kv heads more than one rank
holds, over ``model`` (``parallel/sharding.py::sum_partial``), and the
optimizer's state is ZeRO-1's.  Checkpoints keep the reference's layout
of whole leaves: the world's first rank gathers and writes them
(:func:`gather_train_tree`), and any mesh restores them, each rank its
slices (:func:`restore_train_tree`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.convert import _set_leaf, _to_torch, load_named, named_tree
from repro_torch.optim.optimizers import (
    OptConfig,
    Zero1,
    apply_updates,
    init_state,
    named_params,
)
from repro_torch.parallel.sharding import LeafLayout, Mesh, sum_partial, use_mesh

from . import checkpoint as ckpt_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    grad_accum: int = 1
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    compress_grads: bool = False  # int8 stochastic-rounded gradient exchange
    # manifest-extra dict stored with every checkpoint (e.g. the
    # serialized numerics policy: checkpoint.policy_extra(policy))
    ckpt_extra: Optional[dict] = None


def _int8_compress(g: torch.Tensor, generator: torch.Generator, mesh: Optional[Mesh] = None,
                   lay: Optional[LeafLayout] = None) -> torch.Tensor:
    """Stochastic-rounded int8 quantization of a gradient tensor, in f32.

    Models compressed gradient exchange (the all-reduce would move 1/4
    of the bytes).  Unbiased: E[result] == g.  A leaf cut over the mesh's
    model axis (``lay``) takes the whole leaf's largest magnitude and its
    slice of the whole leaf's noise, so that the ranks' results are the
    slices of one rank's.
    """
    g = g.to(torch.float32)
    cut = lay is not None and lay.dim is not None and not lay.partial
    amax = torch.max(torch.abs(g))
    if cut:
        amax = mesh.all_reduce(amax, op="max")
    scale = (amax + 1e-12) / 127.0
    noise = torch.rand(lay.shape if cut else g.shape, generator=generator, device=g.device) - 0.5
    if cut:
        noise = lay.local(noise, mesh.model_rank)
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def _compress_generator(step: int, device) -> torch.Generator:
    seed = np.random.SeedSequence([17, step]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def compress_grads(grads: Dict[str, Optional[torch.Tensor]], step: int,
                   zero: Optional[Zero1] = None) -> Dict[str, Optional[torch.Tensor]]:
    """Every gradient through :func:`_int8_compress`, in order, its noise
    from one generator seeded by ``step``; under ``zero`` each rank's
    (the data-reduced ones) is its slice of one rank's result."""
    gen, out = None, {}
    for n, g in grads.items():
        if g is not None:
            gen = gen or _compress_generator(step, g.device)
            g = _int8_compress(g, gen, None if zero is None else zero.mesh,
                               None if zero is None else zero.layouts[n])
        out[n] = g
    return out


def _grads(loss_fn, params, named, batch):
    """(loss, name -> gradient or None) of one batch."""
    loss = loss_fn(params, batch)
    leaves = [p for p in named.values() if p.requires_grad]
    if loss.requires_grad and leaves:
        got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        grads = {n: next(got) if p.requires_grad else None for n, p in named.items()}
    else:  # no parameter reaches the loss through a differentiable path
        grads = {n: None for n in named}
    return loss.detach(), grads


def _split(batch, accum: int):
    """The reference's ``x.reshape(accum, -1, *x.shape[1:])``: micro-batch
    i holds rows i*B/accum .. (i+1)*B/accum."""
    return [{k: v.reshape(accum, -1, *v.shape[1:])[i] if v.dim() >= 1 else v
             for k, v in batch.items()} for i in range(accum)]


def local_rows(batch, mesh: Mesh, accum: int = 1):
    """This data rank's rows of a global batch: of each of the ``accum``
    micro-batches (the reference's split, :func:`_split`), its block of
    B / (accum * data) rows, micro-batch by micro-batch (``data``: the
    mesh's batch axis, which folds in a ``pod`` axis)."""
    data, d = mesh.batch_size, mesh.batch_rank
    if data == 1:
        return batch
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        out[k] = (v.reshape(accum, data, -1, *v.shape[1:])[:, d].reshape(-1, *v.shape[1:])
                  if v.dim() >= 1 else v)
    return out


def _data_sum(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """g summed over ``data`` in f32.  Over two data ranks a bf16 gradient
    crosses as its two-byte bits (an all-gather) and the two are added
    here in f32: one rounding, in either order the f32 all-reduce's
    result, with half its bytes."""
    if mesh.batch_size == 2 and g.dtype == torch.bfloat16:
        a, b = mesh.all_gather(g, mesh.batch_axis)
        return a.to(torch.float32) + b.to(torch.float32)
    return mesh.all_reduce(g.to(torch.float32), mesh.batch_axis)


def _reduce_over_mesh(zero: Zero1, loss, grads):
    """The global batch's loss and gradients from this rank's: summed over
    ``data`` (the gradients in f32, :func:`_data_sum`), a ``partial``
    leaf's over ``model`` into its whole."""
    mesh = zero.mesh
    if mesh.batch_size > 1:
        dev = next((g.device for g in grads.values() if g is not None), loss.device)
        loss = mesh.all_reduce(loss.to(dev), mesh.batch_axis)
        grads = {n: None if g is None else _data_sum(g, mesh) for n, g in grads.items()}
    for n, g in grads.items():
        if g is not None and zero.layouts[n].partial:
            grads[n] = sum_partial(g, zero.layouts[n], mesh)
    return loss, grads


def make_train_step(loss_fn: Callable, tcfg: TrainConfig, zero: Optional[Zero1] = None):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics), updating params and state in place.

    With grad_accum > 1 the batch is split on its leading axis into
    micro-batches whose f32 gradients are summed (activation memory
    drops by the accumulation factor).  Under ``zero`` (a ``Zero1``) the
    params are this rank's shard, ``batch`` is the global batch, and the
    step runs over the ranks of ``zero.mesh`` (the module docstring).
    """
    mesh = None if zero is None else zero.mesh

    def train_step(params, opt_state, batch):
        named = named_params(params)
        with use_mesh(mesh):
            if mesh is not None:
                batch = local_rows(batch, mesh, tcfg.grad_accum)
            if tcfg.grad_accum > 1:
                loss = torch.zeros((), dtype=torch.float32)
                grads: Dict[str, Optional[torch.Tensor]] = {n: None for n in named}
                for mb in _split(batch, tcfg.grad_accum):
                    l, g = _grads(loss_fn, params, named, mb)
                    loss = loss + l.cpu()
                    for n, gi in g.items():
                        if gi is not None:
                            gi = gi.to(torch.float32)
                            grads[n] = gi if grads[n] is None else grads[n] + gi
                loss = loss / tcfg.grad_accum
                grads = {n: None if g is None else g / tcfg.grad_accum
                         for n, g in grads.items()}
            else:
                loss, grads = _grads(loss_fn, params, named, batch)
        if zero is not None:
            loss, grads = _reduce_over_mesh(zero, loss, grads)

        if tcfg.compress_grads:
            grads = compress_grads(grads, int(opt_state["step"]), zero)
        apply_updates(tcfg.opt, params, grads, opt_state, zero=zero)
        return params, opt_state, {"loss": loss, "step": opt_state["step"]}

    return train_step


class FailureInjector:
    """Deterministic crash simulator for fault-tolerance tests and drills."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.tripped = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.tripped:
            self.tripped.add(step)
            raise RuntimeError(f"[injected] node failure at step {step}")


def train_tree(params, opt_state):
    """``(params, opt_state)`` as the reference's checkpoint tree (torch
    leaves on the host, per-layer leaves stacked on [L])."""
    state = {k: named_tree(v) for k, v in opt_state.items() if k != "step"}
    state["step"] = opt_state["step"].detach().cpu()
    return named_tree(named_params(params)), state


def _tree_of(leaves: Dict[str, object]) -> Dict:
    """The nested tree of path -> leaf."""
    tree: Dict = {}
    for path, leaf in leaves.items():
        _set_leaf(tree, path, leaf)
    return tree


@torch.no_grad()
def gather_train_tree(params, opt_state, zero: Zero1):
    """``train_tree(params, opt_state)`` of the whole model from the ranks'
    shards, on the world's first rank (host tensors, whole leaves stacked
    on [L]); None on the other ranks.  Each leaf crosses once: the
    parameters (and state that ZeRO-1 does not cut) from the first data
    rank's model group, the cut state from every rank."""
    mesh = zero.mesh
    named = named_params(params)
    keys = [k for k in opt_state if k != "step"]
    first = mesh.rank == 0
    p_leaves, s_leaves = {}, {k: {} for k in keys}

    def whole(lay: LeafLayout, names, parts, sliced: bool):
        """The stacked whole leaf [L or 1, *shape] from the ranks' parts."""
        m = mesh.model_size
        if not sliced:
            return lay.whole(parts[:m], lead=1)
        rows = [lay.whole(parts[d * m:(d + 1) * m], lead=1) for d in range(mesh.data_size)]
        return torch.cat(rows, dim=0 if names[0] in zero.owner else zero.sdim[names[0]] + 1)

    for path, names in zero.by_path.items():
        lay = zero.layouts[names[0]]
        stacked = lay.layer is not None
        sliced = zero.sliced(names[0])
        groups = [(p_leaves, lambda n: named[n], False)]
        groups += [(s_leaves[k], lambda n, k=k: opt_state[k].get(n), sliced) for k in keys]
        for out, get, cut in groups:
            if not cut and mesh.data_rank != 0:
                continue
            mine = torch.stack([t.detach() for t in map(get, names) if t is not None])
            parts = mesh.gather_to_first(mine, None if cut else "model")
            if first:
                w = whole(lay, names, parts, cut)
                out[path] = w if stacked else w[0]
    if not first:
        return None
    state = {k: _tree_of(v) for k, v in s_leaves.items()}
    state["step"] = opt_state["step"].detach().cpu()
    return _tree_of(p_leaves), state


def _whole_like(zero: Zero1, opt_state):
    """The whole checkpoint tree's shapes (meta tensors) for this model."""
    leaves = {}
    for path, names in zero.by_path.items():
        lay = zero.layouts[names[0]]
        shape = ((zero.depth[path],) if lay.layer is not None else ()) + lay.shape
        leaves[path] = torch.empty(shape, device="meta")
    tree = _tree_of(leaves)
    state = {k: tree for k in opt_state if k != "step"}
    state["step"] = torch.empty((), device="meta")
    return tree, state


@torch.no_grad()
def restore_train_tree(ckpt_dir: str, params, opt_state, zero: Zero1,
                       step: Optional[int] = None):
    """Elastic restore: a checkpoint of whole leaves (either package's)
    into this rank's shard of params and opt_state, in place, whatever
    mesh wrote it: each leaf, as it is read, gives every layer its
    tensor-parallel slice and its ZeRO-1 slice.  Returns the manifest."""
    named = named_params(params)
    mr = zero.mesh.model_rank

    def place(kind, path):
        names = zero.by_path[path]

        def put(arr):
            for n in names:
                lay = zero.layouts[n]
                part = arr[lay.layer] if lay.layer is not None else arr
                local = _to_torch(lay.local(part, mr))
                if kind == "params":
                    named[n].copy_(local)
                elif (dst := opt_state[kind].get(n)) is not None:
                    dst.copy_(zero.slice(n, local))
            return None
        return put

    like = _whole_like(zero, opt_state)
    shard = (_tree_of({path: place("params", path) for path in zero.by_path}),
             {k: (_tree_of({path: place(k, path) for path in zero.by_path}) if k != "step"
                  else (lambda arr: arr)) for k in like[1]})
    tree, manifest = ckpt_lib.restore(ckpt_dir, like, step=step, shardings=shard)
    opt_state["step"] = torch.tensor(int(np.asarray(tree[1]["step"])), dtype=torch.int32)
    return manifest


def load_train_tree(tree, params, opt_state) -> None:
    """Copy a checkpoint tree (from :func:`train_tree`'s layout, either
    package's) into params and opt_state in place."""
    p_tree, s_tree = tree
    load_named(p_tree, named_params(params))
    for k, v in opt_state.items():
        if k == "step":
            opt_state["step"] = torch.tensor(int(np.asarray(s_tree["step"])),
                                             dtype=torch.int32)
        else:
            load_named(s_tree[k], v)


def run(
    *,
    loss_fn,
    init_params_fn,
    batch_fn,  # step -> batch
    tcfg: TrainConfig,
    num_steps: int,
    failure: Optional[FailureInjector] = None,
    max_restarts: int = 3,
    zero: Optional[Zero1] = None,
):
    """Drive training with checkpoint/restart.  On an (injected) step
    failure the loop restores the last checkpoint and continues; the data
    pipeline is stateless, so batches replay identically.

    Under ``zero`` every rank of its mesh runs this with the same
    arguments: ``init_params_fn`` gives the rank's shard, ``batch_fn``
    the global batch; every rank restores (its slices) and replays the
    same batches, and the first rank writes each checkpoint of whole
    leaves, the others waiting for it."""
    step_fn = make_train_step(loss_fn, tcfg, zero)

    def fresh():
        params = init_params_fn()
        return params, init_state(tcfg.opt, params, zero), 0

    def restore_into(params, opt_state):
        if zero is not None:
            restore_train_tree(tcfg.ckpt_dir, params, opt_state, zero)
            return
        tree, _ = ckpt_lib.restore(tcfg.ckpt_dir, train_tree(params, opt_state))
        load_train_tree(tree, params, opt_state)

    def save(step, params, opt_state):
        if zero is None:
            ckpt_lib.save(tcfg.ckpt_dir, step, train_tree(params, opt_state),
                          extra=tcfg.ckpt_extra)
            return
        tree = gather_train_tree(params, opt_state, zero)
        if tree is not None:
            ckpt_lib.save(tcfg.ckpt_dir, step, tree, extra=tcfg.ckpt_extra)
        zero.mesh.barrier()

    params, opt_state, start = fresh()
    if tcfg.ckpt_dir and (s := ckpt_lib.latest_step(tcfg.ckpt_dir)) is not None:
        restore_into(params, opt_state)
        start = s

    restarts = 0
    history = []
    step = start
    while step < num_steps:
        try:
            if failure is not None:
                failure.maybe_fail(step)
            batch = batch_fn(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % tcfg.log_every == 0:
                history.append((step, float(metrics["loss"])))
            step += 1
            if tcfg.ckpt_dir and step % tcfg.ckpt_every == 0:
                save(step, params, opt_state)
        except RuntimeError as e:
            if "[injected]" not in str(e) or restarts >= max_restarts:
                raise
            restarts += 1
            if tcfg.ckpt_dir and (s := ckpt_lib.latest_step(tcfg.ckpt_dir)) is not None:
                restore_into(params, opt_state)
                step = s
            else:
                params, opt_state, step = fresh()
    if tcfg.ckpt_dir:
        save(step, params, opt_state)
    return params, opt_state, {"history": history, "restarts": restarts, "final_step": step}
