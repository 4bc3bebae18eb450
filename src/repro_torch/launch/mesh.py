"""Meshes of ranks and their launch (port of ``repro/launch/mesh.py``).

The reference builds a ``jax`` mesh over one process's devices.  The
port runs one process a rank: :func:`spawn` starts the ranks of a
``torch.distributed`` world and runs a function in each, and
:func:`make_host_mesh`, called inside that world, gives the
:class:`~repro_torch.parallel.sharding.Mesh` over its ranks.  The
backend follows one rule (:func:`choose_backend`): ``nccl`` when every
rank has a card of its own, ``gloo`` when ranks share a card or run on
the CPU.  Nothing here touches a device or a process group when it is
imported.

:func:`make_production_mesh` gives the reference's 16 x 16 (2 x 16 x 16)
mesh as a :class:`VirtualMesh`: one rank of it with no world, whose
collectives take meta tensors, move nothing and are counted, so that the
sharded dry run (``launch/dryrun.py``) counts one rank's step of a
256- or 512-card mesh on the CPU.
"""
from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import torch

from repro_torch.parallel.sharding import Mesh

def choose_backend(world: int, device) -> str:
    """``nccl`` when every rank has a card of its own, ``gloo`` when the
    ranks share a card (world > ``torch.cuda.device_count()``) or run on
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_host_mesh(*, data: int = 1, model: int = 1) -> Mesh:
    """The (data, model) mesh over the initialized default group, whose
    world must hold data * model ranks.  Rank r sits at (r // model,
    r % model).  With a data axis above one, each axis' process groups
    are made here, in the same order on every rank (one ``model`` group a
    data index, then one ``data`` group a model index); without one the
    model axis is the default group, as serving has it."""
    import torch.distributed as dist

    n = data * model
    what = f"tp={model}" if data == 1 else f"a mesh of data={data} x model={model}"
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"{what} needs {n} ranks/devices, found no torch.distributed "
                         f"world: start the ranks with repro_torch.launch.mesh.spawn")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"{what} needs {n} ranks/devices, found a world of {world}")
    rank = dist.get_rank()
    groups = {}
    if data > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == rank // model:
                groups["model"] = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == rank % model:
                groups["data"] = g
    return Mesh(rank, model, backend=dist.get_backend(), data=data, groups=groups)


def mesh_dims(mesh: Mesh) -> dict:
    return {a: mesh.shape[a] for a in mesh.axis_names}


class VirtualMesh(Mesh):
    """Rank ``rank`` of a (pod x) data x model mesh with no world: the
    dry run's stand-in for a mesh of cards that this process does not
    have.  Rank r sits at (r // (data model), (r // model) % data,
    r % model), the model groups neighbours as on :class:`Mesh`.  Its
    collectives take meta tensors and give meta results of the shape the
    world's would have, moving nothing; each is counted as the world's
    are (``Mesh._note``: ``traffic``, read back by ``collectives``, and the op
    analysis' listeners), its result bytes as the reference's HLO
    accounting counts them.  A real tensor raises: no fallback computes a
    value.  The ``pod`` axis folds into the batch axis (the reference's
    logical ``batch`` = (pod, data)); ZeRO-1 still cuts over ``data``."""

    def __init__(self, rank: int = 0, *, data: int, model: int, pod: int = 1):
        world = pod * data * model
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a mesh of {pod} x {data} x {model}")
        self.rank = rank
        self.backend = "virtual"
        self.shape = {**({"pod": pod} if pod > 1 else {}), "data": data, "model": model}
        self.axis_names = tuple(self.shape)
        self.batch_axis = "batch" if pod > 1 else "data"
        self.groups = {}
        self.traffic = {}
        self.collective_s = 0.0
        self.time_collectives = False

    @property
    def data_rank(self) -> int:
        return (self.rank // self.shape["model"]) % self.shape["data"]

    @property
    def batch_rank(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def world_size(self) -> int:
        return self.shape.get("pod", 1) * self.shape["data"] * self.shape["model"]

    def axis_size(self, axis: str) -> int:
        if axis == "batch":
            return self.shape.get("pod", 1) * self.shape["data"]
        return self.shape[axis]

    def __repr__(self) -> str:
        return f"VirtualMesh(rank={self.rank}, shape={self.shape})"

    @staticmethod
    def _meta(x: torch.Tensor) -> None:
        if x.device.type != "meta":
            raise ValueError(f"a virtual mesh moves nothing: its collectives take meta "
                             f"tensors, not {x.device.type} ones")

    def all_reduce(self, x: torch.Tensor, axis: str = "model", op: str = "sum") -> torch.Tensor:
        self._meta(x)
        self._note(axis, "all_reduce", x)
        return torch.empty_like(x)

    def all_gather(self, x: torch.Tensor, axis: str = "model") -> List[torch.Tensor]:
        self._meta(x)
        self._note(axis, "all_gather", x)
        return [torch.empty_like(x) for _ in range(self.axis_size(axis))]

    def gather_to_first(self, x, axis=None):
        raise NotImplementedError("a virtual mesh counts a step's collectives; it writes no "
                                  "checkpoint (gather_to_first)")

    def barrier(self) -> None:
        pass


def parse_mesh(spec: str) -> dict:
    """``"DxM"`` or ``"PxDxM"`` -> {"pod": P, "data": D, "model": M}."""
    dims = [int(d) for d in spec.lower().split("x")]
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"a mesh is DxM or PxDxM, not {spec!r}")
    return dict(zip(("pod", "data", "model"), [1] * (3 - len(dims)) + dims))


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def make_virtual_mesh(spec: str, rank: int = 0) -> VirtualMesh:
    """Rank ``rank`` of the virtual mesh ``spec`` (:func:`parse_mesh`)."""
    return VirtualMesh(rank, **parse_mesh(spec))


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> VirtualMesh:
    """Rank ``rank`` of the reference's 16 x 16 = 256-card mesh (2 x 16 x 16
    = 512 across two pods, ``repro/launch/mesh.py``), as a
    :class:`VirtualMesh`: its one user is the sharded dry run."""
    return make_virtual_mesh("2x16x16" if multi_pod else "16x16", rank)


def rank_device(rank: int, device) -> torch.device:
    """The device of rank ``rank``: ``cuda:(rank % device_count)`` on the
    cards (explicit, never the CPU unless asked), or the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank, world, store_path, backend, device, threads, fn, args, results):
    """One rank: join the world through the file store, run fn, report."""
    import torch.distributed as dist

    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world)
        # by value: torch's queue would pass a tensor's storage by a handle
        # that dies with this process
        msg = (rank, True, pickle.dumps(fn(str(dev), *args)))
    except Exception:  # noqa: BLE001 - every failure goes to the parent
        msg = (rank, False, traceback.format_exc())
    results.put(msg)
    results.close()
    results.join_thread()
    if msg[1]:
        dist.destroy_process_group()


def spawn(fn: Callable, tp: int, device, *args, threads: Optional[int] = None,
          timeout: Optional[float] = None) -> List:
    """Run ``fn(rank_device, *args)`` in each of ``tp`` new processes, the
    ranks of one ``torch.distributed`` world (``tp`` = data x model ranks
    for a training mesh), and return their results in rank order.

    The ranks start from ``torch.multiprocessing``'s spawn context (so
    ``fn`` and ``args`` must pickle: ``fn`` a module-level function) and
    meet through a ``FileStore`` in a temporary directory, never a fixed
    TCP port.  ``device``: ``"cpu"``, or ``"cuda"``/None for the cards
    (rank r on ``cuda:(r % device_count)``).  The backend is
    :func:`choose_backend`'s, and the run prints which; one that fails
    to initialize raises.  On the cards the kernels are built here
    first, once, so that the ranks only load the library.  ``threads``
    sets each rank's intra-op threads.  A rank that fails
    (an exception, a crash, or ``timeout`` seconds passing) fails the
    call: the other ranks are stopped and its traceback raised."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("spawn on the cards: no CUDA device is available; pass "
                               "device='cpu' to run the ranks on the CPU")
        from repro_torch.kernels import _lib

        _lib.build()
    backend = choose_backend(tp, dev)
    shared = dev.type == "cuda" and tp > torch.cuda.device_count()
    print(f"mesh: {tp} ranks on {dev.type} over {backend}"
          + (f" (they share {torch.cuda.device_count()} card(s))" if shared else ""), flush=True)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got, failure = {}, None
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, tp, store, backend, str(dev), threads,
                                                      fn, args, results))
                 for r in range(tp)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while len(got) < tp and failure is None:
                try:
                    rank, ok, out = results.get(timeout=0.5)
                except queue.Empty:
                    crashed = [r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0) and r not in got]
                    if crashed:
                        failure = (f"rank {crashed[0]} exited with code "
                                   f"{procs[crashed[0]].exitcode} before reporting")
                    elif deadline is not None and time.monotonic() > deadline:
                        failure = f"the ranks did not finish within {timeout} s"
                    continue
                if ok:
                    got[rank] = pickle.loads(out)
                else:
                    failure = f"rank {rank} failed:\n{out}"
        finally:
            for p in procs:
                if failure is None:
                    p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
                    p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(tp)]
