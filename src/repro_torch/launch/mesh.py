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

#: the item of ROADMAP.md's queue 1 that holds the sharded dry run and the
#: reference's production meshes (its one user)
TP_TRAINING = "8b: the sharded dry run and the production meshes"


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


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16 x 16 (2 x 16 x 16 across two pods) mesh, whose
    one user is the sharded dry run."""
    from repro_torch.serving.api import LATER

    what = "the 2-pod mesh" if multi_pod else "the production mesh"
    raise NotImplementedError(f"{what} " + LATER.format(TP_TRAINING))


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
