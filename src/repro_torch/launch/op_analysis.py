"""Op-level analysis of one eager step (the port's counterpart of
``repro/launch/hlo_analysis.py``).

The reference parses a compiled HLO module; eager PyTorch has no HLO, so
this module watches the step itself, op by op, under a
``TorchDispatchMode`` (``torch.utils._python_dispatch``), on meta
tensors (the dry run, ``launch/dryrun.py``) or real ones.  The unit is
the aten op: in eager mode each op is one launch and one round trip to
device memory, which is what the XLA fusion boundary is to the
reference.  Eager code runs every iteration of a loop, so the reference's
trip-count correction has no counterpart here: a layer loop of L layers
dispatches its ops L times.

Per step it records

  * matmul FLOPs          mm, bmm, addmm, baddbmm, convolution and the
                          SDPA kernels, by ``torch.utils.flop_counter``'s
                          formulas, split by class: ``bf16`` (bf16 and
                          fp16 on the tensor cores), ``tf32`` (f32 with
                          ``torch.backends.cuda.matmul.allow_tf32`` on),
                          ``f32`` (the CUDA cores)
  * ``elem_ops``          the result elements of every other compute op
                          (the reference's VPU proxy)
  * ``hbm_bytes``         the operand and result bytes of each op; views
                          and metadata ops count 0 (the reference's
                          ``_SKIP_OPS``), a gather reads and writes its
                          result, a scatter its update, a copy its source
                          and destination
  * the port's kernels    every launch of ``repro_torch.kernels`` (on meta
                          tensors too, where it runs nothing) with its
                          integer lane operations, f32 FLOPs and bytes
                          (``kernels/_lib.py::launch``)
  * collectives           result bytes and counts by type, and by mesh
                          axis (the group each ran over and its size):
                          those a mesh runs (``parallel/sharding.py::
                          Mesh``, which tells ``collective_listeners``;
                          a virtual mesh's on meta tensors too) and any
                          functional collective op
  * live bytes            the bytes of the storages the step creates,
                          through weak references to them: their peak and
                          what is still alive at the end, so a dry run on
                          meta gets its temporaries without allocating
                          anything

Only ``torch.utils.flop_counter`` and ``TorchDispatchMode`` are used.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import defaultdict
from typing import Dict, Iterable, List

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _lib
from repro_torch.parallel import sharding

aten = torch.ops.aten

_COLL_NAMES = {"all_gather": "all-gather", "all_reduce": "all-reduce",
               "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
               "send": "collective-permute", "recv": "collective-permute"}

# ops that move no data of their own (besides the views, which every
# schema marks): the allocations, metadata and no-op aliases
_NO_TRAFFIC = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.lift_fresh, aten._unsafe_view,
    aten.alias, aten.set_, aten.resize_, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.is_same_size, aten.is_nonzero,
    aten._local_scalar_dense, aten.record_stream,
}
# a gather reads and writes its result (plus its indices)
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding, aten.take}
# a scatter reads and writes its update (plus its indices)
_SCATTERS = {aten.index_put_, aten.index_put, aten.index_copy_, aten.index_copy,
             aten.index_add_, aten.index_add, aten.scatter_, aten.scatter,
             aten.scatter_add_, aten.scatter_add, aten.slice_scatter,
             aten.select_scatter, aten._index_put_impl_}
# write-only results
_FILLS = {aten.fill_, aten.zero_}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> float:
    """Bytes a tensor's elements span: at most its storage's (a broadcast
    view reads each stored element once)."""
    return float(min(t.numel() * t.element_size(), t.untyped_storage().nbytes()))


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def matmul_class(dtype: torch.dtype) -> str:
    """The compute class of a matmul whose result is ``dtype``."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "f32"


def _collective(func):
    if func.namespace not in ("_c10d_functional", "c10d", "c10d_functional"):
        return None
    name = func._overloadpacket.__name__
    return next((v for k, v in _COLL_NAMES.items() if k in name), None)


@dataclasses.dataclass
class Analysis:
    """The totals of one step, with the reference's fields (``flops``,
    ``elem_ops``, ``hbm_bytes``, the collectives) and the port's: the
    matmul FLOPs by class, the kernels' work by name, live bytes."""

    flops: float = 0.0
    flops_by_class: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    elem_ops: float = 0.0
    hbm_bytes: float = 0.0
    int_ops: float = 0.0
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    # axis -> {"group": its size, "bytes": {kind: bytes}, "counts": {kind: calls}}
    collective_by_axis: Dict[str, dict] = dataclasses.field(default_factory=dict)
    peak_live_bytes: float = 0.0
    end_live_bytes: float = 0.0
    ops: List[dict] = dataclasses.field(default_factory=list)

    @property
    def collective_total(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def as_dict(self):
        return {
            "flops": self.flops,
            "flops_by_class": dict(self.flops_by_class),
            "elem_ops": self.elem_ops,
            "hbm_bytes": self.hbm_bytes,
            "int_ops": self.int_ops,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "collective_total": self.collective_total,
            "by_axis": {a: {"group": v["group"], "bytes": dict(v["bytes"]),
                            "counts": dict(v["counts"])}
                        for a, v in self.collective_by_axis.items()},
        }

    def record_fields(self) -> dict:
        """The dry-run record's fields that this analysis gives."""
        return {"flops": self.flops, "flops_by_class": dict(self.flops_by_class),
                "elem_ops": self.elem_ops, "bytes_accessed": self.hbm_bytes,
                "int_ops": self.int_ops, "kernel_work": self.kernels,
                "collectives": self.as_dict()}

    def add(self, rec: dict) -> None:
        """Fold one op's record (an entry of :attr:`ops`) into the totals."""
        self.flops += rec.get("flops", 0.0)
        if rec.get("class"):
            self.flops_by_class[rec["class"]] += rec.get("flops", 0.0)
        self.elem_ops += rec.get("elems", 0.0)
        self.hbm_bytes += rec.get("bytes", 0.0)
        self.int_ops += rec.get("int_ops", 0.0)
        if rec.get("coll"):
            self.collective_bytes[rec["coll"]] += rec["bytes"]
            self.collective_counts[rec["coll"]] += 1
            if rec.get("axis"):
                ax = self.collective_by_axis.setdefault(
                    rec["axis"], {"group": rec["group"], "bytes": defaultdict(float),
                                  "counts": defaultdict(float)})
                ax["bytes"][rec["coll"]] += rec["bytes"]
                ax["counts"][rec["coll"]] += 1
        if rec.get("kernel"):
            k = self.kernels.setdefault(rec["kernel"], {"launches": 0, "int_ops": 0.0,
                                                        "flops": 0.0, "bytes": 0.0})
            k["launches"] += 1
            for f in ("int_ops", "flops", "bytes"):
                k[f] += rec.get(f, 0.0)
        self.ops.append(rec)

    @classmethod
    def from_trace(cls, records: Iterable[dict]) -> "Analysis":
        """The totals of an archived op trace (``OpAnalysis.ops``)."""
        out = cls()
        for rec in records:
            out.add(rec)
        return out


def top_contributors(ana: Analysis, *, key: str = "bytes", n: int = 20):
    """Top-n (contribution, op, input shapes, count) over the step's ops,
    identical (op, shapes) summed -- the profiling view: what to optimize
    next.  ``key``: "flops", "bytes" or "collective"."""
    field = {"flops": "flops", "bytes": "bytes", "collective": "bytes"}[key]
    agg: Dict[tuple, list] = {}
    for rec in ana.ops:
        if key == "collective" and not rec.get("coll"):
            continue
        v = rec.get(field, 0.0)
        if v <= 0:
            continue
        k = (rec.get("kernel") or rec["op"], str(rec.get("shapes")))
        a = agg.setdefault(k, [0.0, 0])
        a[0] += v
        a[1] += 1
    items = sorted(((v, op, shapes, c) for (op, shapes), (v, c) in agg.items()), reverse=True)
    return items[:n]


class OpAnalysis(TorchDispatchMode):
    """``with OpAnalysis() as oa: step()`` -> ``oa.result``, an
    :class:`Analysis` of every aten op and kernel launch of the step."""

    def __init__(self):
        super().__init__()
        self.result = Analysis()
        # storage id -> (weak ref, bytes, created by the step)
        self._storages: Dict[int, tuple] = {}
        self._live = 0.0

    # -- live bytes ----------------------------------------------------------

    def _see(self, t: torch.Tensor, created: bool) -> None:
        st = t.untyped_storage()
        key = st._cdata
        known = self._storages.get(key)
        if known is not None and not known[0].expired():
            return
        nb = float(st.nbytes())
        if created and self._live + nb > self.result.peak_live_bytes:
            # the count may still hold storages freed since the last sweep:
            # it is exact after one, and only a new peak needs it exact
            self._sweep()
        self._storages[key] = (StorageWeakRef(st), nb, created)
        if created:
            self._live += nb
            self.result.peak_live_bytes = max(self.result.peak_live_bytes, self._live)

    def _sweep(self) -> None:
        dead = [k for k, (ref, _, _) in self._storages.items() if ref.expired()]
        for k in dead:
            _, nb, created = self._storages.pop(k)
            if created:
                self._live -= nb

    # -- the kernels' launches (kernels/_lib.py::launch) --------------------

    def _kernel(self, name: str, work) -> None:
        self.result.add({"op": "kernel", "kernel": name, "int_ops": work.int_ops,
                         "flops": work.flops, "class": "f32" if work.flops else None,
                         "bytes": work.bytes, "shapes": [list(s) for s in work.shapes],
                         "dtypes": list(work.dtypes)})

    # -- a mesh's collectives (parallel/sharding.py::Mesh._note) ------------

    def _mesh_collective(self, kind: str, axis: str, group: int, nbytes: int) -> None:
        self.result.add({"op": "collective", "coll": kind, "axis": axis, "group": group,
                         "bytes": float(nbytes)})

    def __enter__(self):
        _lib.listeners.append(self._kernel)
        sharding.collective_listeners.append(self._mesh_collective)
        return super().__enter__()

    def __exit__(self, *exc):
        _lib.listeners.remove(self._kernel)
        sharding.collective_listeners.remove(self._mesh_collective)
        self._sweep()
        self.result.end_live_bytes = self._live
        return super().__exit__(*exc)

    # -- the ops --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_view(func):  # no data moved, no storage made: not recorded
            return func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        for t in ins:
            self._see(t, created=False)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._see(t, created=True)
        self.result.add(self._record(func, args, kwargs, ins, outs, out))
        return out

    def _record(self, func, args, kwargs, ins, outs, out) -> dict:
        packet = func._overloadpacket
        rec = {"op": str(packet).replace("aten.", ""),
               "shapes": [list(t.shape) for t in ins]}
        coll = _collective(func)
        if coll is not None:
            rec.update(coll=coll, bytes=sum(_nbytes(t) for t in outs))
            return rec
        if packet in flop_registry:
            rec.update(flops=float(flop_registry[packet](*args, **kwargs, out_val=out)),
                       bytes=sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
            rec["class"] = matmul_class(outs[0].dtype) if outs else "f32"
            return rec
        if packet in _NO_TRAFFIC:
            return rec
        elems = float(sum(t.numel() for t in outs))
        if packet in _GATHERS:
            nb = 2 * sum(map(_nbytes, outs)) + sum(
                _nbytes(t) for t in ins[1:] if not t.is_floating_point())
        elif packet in _SCATTERS:
            nb = 2 * sum(map(_nbytes, ins[1:]))
            elems = float(sum(t.numel() for t in ins[1:] if t.is_floating_point()))
        elif packet in _FILLS:
            nb = sum(map(_nbytes, outs))
        elif packet is aten.copy_:
            nb = _nbytes(ins[0]) + _nbytes(ins[1])
        else:
            nb = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        rec.update(elems=elems, bytes=float(nb))
        return rec
