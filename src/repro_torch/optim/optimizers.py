"""Optimizers (SGD / Nesterov / Adam / AdamW), port of
``repro/optim/optimizers.py``.

The paper's experiments use SGD, Nesterov and Adam (Table I); AdamW is
the default for the LM-scale runs.  Parameters are a mapping of name ->
tensor (``dict(model.named_parameters())`` or a paper model's dict), and
the state holds one f32 tensor per parameter and name.  The update runs
parameter by parameter, in place: gradients are clipped by their global
norm, the master math is f32, and each parameter is cast back to its
storage dtype.  No f32 copy of all gradients is held at once.

Under a mesh of ranks (:class:`Zero1`, the port of the reference's
``state_shardings``) each state tensor takes its parameter's
tensor-parallel slice and, ZeRO-1, is cut once more over the data axis
on the first divisible dimension the parameter's rule leaves free
(:func:`zero1_dims`, the reference's ``_zero1_dims``): for a layer
weight, stacked on [L] in the reference's layout, that is usually L, so
each data rank holds the state of L / data whole layers.  The gradient
norm is the whole model's (:meth:`Zero1.global_norm`), and each data
rank updates the slice its state covers, then gathers the updated
parameters over ``data``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

import torch
from torch import nn

from repro_torch.parallel.sharding import LeafLayout, Mesh, sanitize, spec_for_param


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adam | sgd | nesterov
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 1.0


def named_params(params) -> Dict[str, torch.Tensor]:
    """name -> tensor for a model (its float parameters) or a mapping."""
    if isinstance(params, nn.Module):
        return {n: p for n, p in params.named_parameters() if p.is_floating_point()}
    return dict(params)


def init_state(cfg: OptConfig, params, zero: Optional["Zero1"] = None):
    """Zero state for every float parameter; under ``zero`` for the slice of
    it this rank's state covers (none for a layer another data rank
    holds)."""
    named = named_params(params)

    def zeros():
        out = {}
        for n, p in named.items():
            part = p if zero is None else zero.slice(n, p)
            if part is not None:
                out[n] = torch.zeros(part.shape, dtype=torch.float32, device=p.device)
        return out

    step = torch.zeros((), dtype=torch.int32)
    if cfg.name in ("adam", "adamw"):
        return {"m": zeros(), "v": zeros(), "step": step}
    if cfg.name in ("sgd", "nesterov"):
        return {"mu": zeros(), "step": step}
    raise ValueError(cfg.name)


def global_norm(grads: Mapping[str, Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in f32 (one leaf's f32
    copy at a time); a ``None`` gradient counts as zero."""
    total = None
    for g in grads.values():
        if g is None:
            continue
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq.to(total.device)
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def _update(cfg: OptConfig, p, g32, st: Dict[str, torch.Tensor], bc, lr):
    """One parameter's (or slice's) new value in f32; its state ``st``
    updated in place.  ``g32`` None: a zero gradient."""
    if cfg.name in ("adam", "adamw"):
        b1, b2 = cfg.beta1, cfg.beta2
        m, v = st["m"], st["v"]
        m.mul_(b1)
        v.mul_(b2)
        if g32 is not None:
            m.add_((1 - b1) * g32)
            v.add_((1 - b2) * g32 * g32)
        u = (m / bc[0]) / (torch.sqrt(v / bc[1]) + cfg.eps)
        if cfg.name == "adamw" and cfg.weight_decay:
            u = u + cfg.weight_decay * p.to(torch.float32)
    else:
        mu = st["mu"]
        mu.mul_(cfg.momentum)
        if g32 is not None:
            mu.add_(g32)
        if cfg.name == "nesterov":
            u = cfg.momentum * mu if g32 is None else g32 + cfg.momentum * mu
        else:
            u = mu
    return p.to(torch.float32) - lr * u


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads: Mapping[str, Optional[torch.Tensor]],
                  state, lr_scale: float = 1.0, zero: Optional["Zero1"] = None):
    """One optimizer step, in place.  Returns (params, state).

    ``grads`` maps each parameter's name to its gradient or ``None`` (no
    gradient reached it, as under ``plam_sim``, whose products go through
    integer patterns): the reference's zero gradient.  Under ``zero`` the
    gradients are the data-reduced ones (a ``partial`` leaf's whole, as
    :meth:`Zero1.global_norm` takes them), each rank updates its state's
    slices and the parameters are gathered over ``data``.
    """
    named = named_params(params)
    f32 = torch.float32
    dev = next(iter(named.values())).device
    gnorm = (global_norm(grads) if zero is None else zero.global_norm(grads)).to(dev)
    clip = torch.minimum(torch.ones((), dtype=f32, device=dev),
                         cfg.grad_clip / (gnorm + 1e-12))
    step = state["step"] + 1
    lr = cfg.lr * lr_scale
    stepf = step.to(f32)
    bc = None
    if cfg.name in ("adam", "adamw"):
        bc = ((1 - torch.tensor(cfg.beta1, dtype=f32) ** stepf).to(dev),
              (1 - torch.tensor(cfg.beta2, dtype=f32) ** stepf).to(dev))
    keys = [k for k in state if k != "step"]
    updated = {}
    for name, p in named.items():
        g = grads.get(name)
        if zero is not None:
            if g is not None:
                g = zero.slice(name, zero.local_grad(name, g))
            p = zero.slice(name, p)
            if p is None:  # another data rank holds this layer's state
                continue
        g32 = None if g is None else g.to(f32) * clip
        new = _update(cfg, p, g32, {k: state[k][name] for k in keys}, bc, lr)
        if zero is None or not zero.sliced(name):
            p.copy_(new.to(p.dtype))
        else:
            updated[name] = new.to(p.dtype)
        del g32, new
    if zero is not None:
        zero.gather_updates(named, updated)
    state["step"] = step
    return params, state


# ---------------------------------------------------------------------------
# ZeRO-1 sharding of optimizer state
# ---------------------------------------------------------------------------


def zero1_dims(path: str, shape, mesh, rules=None) -> tuple:
    """The reference's ``_zero1_dims`` of a leaf of ``shape`` (stacked on
    [L] for a layer weight): its parameter's logical dims, ``sanitize``d,
    and ``"seq"`` (the data axis) on the first free dim the data axis
    divides."""
    dims = list(sanitize(mesh, spec_for_param(path, len(shape), rules), tuple(shape)))
    if "data" in mesh.axis_names:
        dsz = mesh.shape["data"]
        for i, d in enumerate(dims):
            if d is None and shape[i] % dsz == 0 and shape[i] >= dsz:
                dims[i] = "seq"  # logical 'seq' resolves to the data axis
                break
    return tuple(dims)


def zero1_numel(shape, dims, mesh) -> int:
    """Elements a device holds of a leaf of ``shape`` laid out by ``dims``
    (``model`` and ``seq`` cut their dims by their axes' sizes)."""
    n = 1
    for size, d in zip(shape, dims):
        n *= size // {"model": mesh.shape["model"], "seq": mesh.shape["data"]}.get(d, 1)
    return n


class Zero1:
    """ZeRO-1 under a mesh: where each parameter's state lives (the port of
    the reference's ``state_shardings``).  The reference applies
    :func:`zero1_dims` to leaves stacked on [L]; the port keeps a tensor a
    layer, so the dims are computed on the stacked shape (L, *shape) and
    layer i's state goes where the reference's [L] sharding puts row i:
    on data rank ``i // (L / data)`` when the data dim is L (``owner``),
    else each layer's state cut on the same dim (``sdim``).  L is the depth
    of the leaf's own stack (``depth``: the layers that hold it, so the
    encoder-decoder's ``enc_layers`` and ``dec_layers`` each their own).
    The bytes a rank holds are the reference's per-device bytes, but for
    ``wk``/``wv`` where kv < tp, whose heads a rank keeps whole
    (``kv_heads_for_rank``).

    ``layouts``: each parameter's :class:`LeafLayout` (``leaf_layouts``)."""

    def __init__(self, layouts: Dict[str, LeafLayout], mesh: Mesh):
        self.layouts, self.mesh = layouts, mesh
        self.owner: Dict[str, int] = {}
        self.sdim: Dict[str, int] = {}
        self.by_path: Dict[str, List[str]] = {}
        for name, lay in layouts.items():
            self.by_path.setdefault(lay.path, []).append(name)
        #: the depth of each stacked leaf's stack, by path
        self.depth: Dict[str, int] = {path: len(names) for path, names in self.by_path.items()
                                      if layouts[names[0]].layer is not None}
        data = mesh.data_size
        for name, lay in layouts.items():
            depth = self.depth.get(lay.path)
            dims = zero1_dims(lay.path, ((depth,) if depth else ()) + lay.shape, mesh)
            if data == 1 or "seq" not in dims:
                continue
            j = dims.index("seq")
            if depth and j == 0:
                self.owner[name] = lay.layer // (depth // data)
            else:
                self.sdim[name] = j - 1 if depth else j
        for names in self.by_path.values():
            names.sort(key=lambda n: self.layouts[n].layer or 0)

    def sliced(self, name: str) -> bool:
        """Whether the data ranks hold different parts of ``name``'s state."""
        return name in self.owner or name in self.sdim

    def slice(self, name: str, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This data rank's part of ``name``'s local tensor ``t`` (a view; None
        where another data rank holds the layer)."""
        if t is None or not self.sliced(name):
            return t
        if name in self.owner:
            return t if self.owner[name] == self.mesh.data_rank else None
        d = self.sdim[name]
        n = t.shape[d] // self.mesh.data_size
        return t.narrow(d, self.mesh.data_rank * n, n)

    def local_grad(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a ``partial`` leaf's whole gradient; any
        other gradient as it is."""
        lay = self.layouts[name]
        return lay.local(g, self.mesh.model_rank) if lay.partial else g

    def global_norm(self, grads: Mapping[str, Optional[torch.Tensor]]) -> torch.Tensor:
        """The whole model's gradient norm from the ranks' data-reduced
        gradients: the squares of cut leaves summed over ``model``, those of
        replicated leaves (a ``partial`` leaf's whole) counted once."""
        f32 = torch.float32
        dev = next(g.device for g in grads.values() if g is not None)
        cut = torch.zeros((), dtype=f32, device=dev)
        rep = torch.zeros((), dtype=f32, device=dev)
        for name, g in grads.items():
            if g is None:
                continue
            sq = torch.sum(torch.square(g.to(f32)))
            lay = self.layouts[name]
            if lay.dim is not None and not lay.partial:
                cut = cut + sq
            else:
                rep = rep + sq
        return torch.sqrt(self.mesh.all_reduce(cut) + rep)

    @torch.no_grad()
    def gather_updates(self, named: Mapping[str, torch.Tensor],
                       updated: Mapping[str, torch.Tensor]) -> None:
        """Every rank's updated slices of each reference leaf, gathered over
        ``data`` (one all-gather a leaf: its layers stacked) into the
        parameters in place."""
        for names in self.by_path.values():
            names = [n for n in names if self.sliced(n)]
            if not names:
                continue
            mine = torch.stack([updated[n] for n in names if n in updated])
            parts = self.mesh.all_gather(mine, "data")
            if names[0] in self.owner:  # whole layers, data rank d the d-th block
                for n, v in zip(names, torch.cat(parts)):
                    named[n].copy_(v)
            else:
                whole = torch.cat(parts, dim=self.sdim[names[0]] + 1)
                for n, v in zip(names, whole):
                    named[n].copy_(v)

    def state_bytes(self, state) -> int:
        """Bytes of this rank's optimizer state tensors."""
        return sum(t.numel() * t.element_size() for k, part in state.items() if k != "step"
                   for t in part.values())
