"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and there
    is no card, instead of carrying on on the CPU.  Inside a
    ``torch.distributed`` world a CUDA device without an index is the
    rank's own, ``cuda:(rank % device_count)`` (``launch/mesh.py``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions"
        )
    if dev.type == "cuda" and dev.index is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def init_generator(device: torch.device, seed: int) -> torch.Generator:
    """The seeded generator of a model's init on ``device``.  The meta
    device has no generator: its tensors hold no values, and a CPU
    generator stands in for it (``torch.randn(..., generator=<CPU
    generator>, device="meta")`` draws nothing and allocates nothing), so
    a model built on meta has the shapes and dtypes of the real one."""
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    return gen
