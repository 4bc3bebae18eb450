"""Atomic, step-tagged checkpoints in the reference's on-disk layout (port
of ``repro/train/checkpoint.py``), so that each package restores the
other's.

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, written to a
tmp dir and renamed, so a crash mid-save never corrupts the latest
checkpoint.  Leaves are ``leaf_<i>`` in JAX's flatten order (nested
dicts by sorted key, tuples and lists in order) and in the reference's
shapes: the loop saves ``(params, opt_state)`` as
``repro_torch.convert.named_tree`` lays them out (per-layer leaves
stacked on [L]).  A bf16 leaf is written as the reference writes one,
raw two-byte ``'<V2'`` items with ``"bfloat16"`` in the manifest's
``dtypes``, and is read back through the manifest as a ``uint16`` view
(the port's numpy spelling of bf16, which ``convert`` reads), so no
bf16 numpy type is needed.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.policy import policy_from_dict, policy_to_dict

BF16 = "bfloat16"


def _flatten(tree) -> Tuple[List[Any], str]:
    """(leaves, treedef string) as ``jax.tree_util.tree_flatten`` orders
    and prints them; None is an empty subtree."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
        if isinstance(node, tuple):
            inner = ", ".join(walk(x) for x in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if isinstance(node, list):
            return "[" + ", ".join(walk(x) for x in node) + "]"
        if node is None:
            return "None"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(like, leaves: List[Any]):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        if node is None:
            return None
        return next(it)

    return build(like)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, its manifest dtype) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_npz(path: str, arrays: List[Tuple[np.ndarray, str]]) -> None:
    """``np.savez``'s file, with bf16 leaves as the reference's ``'<V2'``."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for i, (arr, dtype) in enumerate(arrays):
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                arr = np.asarray(arr, order="C")  # keeps 0-d leaves 0-d
                if dtype == BF16:
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
                    f.write(arr.tobytes())
                else:
                    np.lib.format.write_array(f, arr, allow_pickle=False)


def save(ckpt_dir: str, step: int, tree, *, extra: Optional[dict] = None, keep: int = 3):
    """Synchronous atomic save of a tree of tensors or arrays."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves, treedef = _flatten(tree)
    arrays = [_host(leaf) for leaf in leaves]
    manifest = {
        "step": int(step),
        "treedef": treedef,
        "n_leaves": len(leaves),
        "dtypes": [dtype for _, dtype in arrays],
        "shapes": [list(arr.shape) for arr, _ in arrays],
        "extra": extra or {},
    }
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        _write_npz(os.path.join(tmp, "arrays.npz"), arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def save_async(ckpt_dir: str, step: int, tree, **kw) -> threading.Thread:
    """Non-blocking save: the device -> host copy happens first, the file
    I/O on a worker thread.  Join the returned thread before reading the
    checkpoint."""
    host_tree = _unflatten(tree, [leaf.detach().cpu().clone()
                                  if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
                                  for leaf in _flatten(tree)[0]])
    t = threading.Thread(target=save, args=(ckpt_dir, step, host_tree), kwargs=kw,
                         daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like_tree, *, step: Optional[int] = None, shardings=None):
    """Restore into the structure of ``like_tree`` (leaves with a
    ``shape``: the whole leaves').  Returns (tree of numpy arrays,
    manifest); bf16 leaves come back as ``uint16`` views.  Raises
    ValueError when the checkpoint's leaf count or a shape differs from
    ``like_tree``'s.

    ``shardings`` (elastic restore under a new mesh, the reference's
    re-placement of each leaf): a tree of ``like_tree``'s structure whose
    leaves are callables, each given its leaf as it is read and returning
    what the restored tree holds in its place (a rank's slices), so that
    no more than one whole leaf is held at a time."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, _ = _flatten(like_tree)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint/model structure mismatch: {manifest['n_leaves']} "
                         f"leaves saved, {len(leaves)} expected")
    places = _flatten(shardings)[0] if shardings is not None else [None] * len(leaves)
    if len(places) != len(leaves):
        raise ValueError(f"{len(places)} shardings for {len(leaves)} leaves")
    new_leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (old, place) in enumerate(zip(leaves, places)):
            arr = data[f"leaf_{i}"]
            if manifest["dtypes"][i] == BF16:
                arr = arr.view(np.uint16)
            if tuple(old.shape) != tuple(arr.shape):
                raise ValueError(f"leaf {i}: shape {tuple(arr.shape)} saved, "
                                 f"{tuple(old.shape)} expected")
            new_leaves.append(arr if place is None else place(arr))
            del arr
    return _unflatten(like_tree, new_leaves), manifest


POLICY_KEY = "numerics_policy"


def policy_extra(numerics) -> dict:
    """Manifest-extra dict carrying a serialized numerics policy."""
    return {POLICY_KEY: policy_to_dict(numerics)}


def manifest_policy(manifest: dict):
    """The NumericsPolicy stored by :func:`policy_extra`, or None when the
    checkpoint carries no policy."""
    data = (manifest.get("extra") or {}).get(POLICY_KEY)
    return None if data is None else policy_from_dict(data)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
