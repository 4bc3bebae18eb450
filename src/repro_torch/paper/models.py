"""The paper's own DNNs (Table I): 2-hidden-layer MLPs, LeNet-5, CifarNet.

Port of ``repro/paper/models.py``.  Parameters are a dict of tensors in
the reference's layout (convolution weights [kh, kw, C, F]), and every
multiplication goes through the numerics-aware ``nmatmul``:
convolutions are lowered to im2col + ``nmatmul``, so PLAM applies to
them as to the dense layers (the K1 kernel on the card).

The reference's im2col (``conv_general_dilated_patches``) orders a
patch's features (C, kh, kw) and multiplies them by
``w.reshape(-1, F)``, whose rows are in (kh, kw, C) order: for C > 1 a
permuted convolution.  ``F.unfold`` orders a patch (C, kh, kw) too, so
``_conv2d`` mirrors it exactly, permutation included.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.dense import dense_init
from repro_torch.core.modes import NumericsConfig, nmatmul
from repro_torch.device import resolve_device

Params = Dict[str, torch.Tensor]


def _same_pad(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv2d(x, w, ncfg: NumericsConfig, stride: int = 1, use_kernel: Optional[bool] = None):
    """x: [B, H, W, C]; w: [kh, kw, C, F], "SAME" padding, via im2col and
    the numerics-aware matmul."""
    kh, kw, c, f = w.shape
    b, h, wd, _ = x.shape
    (pt, pb), (pl, pr) = _same_pad(h, kh, stride), _same_pad(wd, kw, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    patches = F.unfold(xc, (kh, kw), stride=stride)  # [B, C*kh*kw, H'*W']
    ho, wo = -(-h // stride), -(-wd // stride)
    rows = patches.transpose(1, 2).reshape(b * ho * wo, -1)
    out = nmatmul(rows, w.reshape(-1, f), ncfg, out_dtype=x.dtype, use_kernel=use_kernel)
    return out.reshape(b, ho, wo, f)


def _maxpool(x, k: int = 2):
    """k x k max pool, stride k, "VALID", on [B, H, W, C]."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def _zeros(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# MLPs (ISOLET / UCI-HAR rows of Table I)
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, dims) -> Params:
    """dims e.g. (617, 128, 64, 26); drawn on the generator's device."""
    kw = dict(generator=generator, device=generator.device)
    params = {f"w{i}": dense_init(dims[i], dims[i + 1], **kw) for i in range(len(dims) - 1)}
    for i in range(len(dims) - 1):
        params[f"b{i}"] = _zeros(dims[i + 1], params["w0"])
    return params


def mlp_apply(params: Params, x, ncfg: NumericsConfig, use_kernel: Optional[bool] = None):
    n = sum(1 for k in params if k.startswith("w"))
    h = x
    for i in range(n):
        h = nmatmul(h, params[f"w{i}"], ncfg, out_dtype=torch.float32,
                    use_kernel=use_kernel) + params[f"b{i}"]
        if i < n - 1:
            h = F.relu(h)
    return h  # logits


# ---------------------------------------------------------------------------
# LeNet-5 (MNIST / SVHN rows)
# ---------------------------------------------------------------------------

def lenet5_init(generator: torch.Generator, in_ch: int = 1, n_classes: int = 10,
                hw: int = 28) -> Params:
    kw = dict(generator=generator, device=generator.device)
    flat = (hw // 4) * (hw // 4) * 16
    p = {
        "c1": dense_init(5 * 5 * in_ch, 6, **kw).reshape(5, 5, in_ch, 6),
        "c2": dense_init(5 * 5 * 6, 16, **kw).reshape(5, 5, 6, 16),
        "f1": dense_init(flat, 120, **kw),
        "f2": dense_init(120, 84, **kw),
        "f3": dense_init(84, n_classes, **kw),
    }
    p.update(b1=_zeros(120, p["c1"]), b2=_zeros(84, p["c1"]), b3=_zeros(n_classes, p["c1"]))
    return p


def lenet5_apply(params: Params, x, ncfg: NumericsConfig, use_kernel: Optional[bool] = None):
    kw = dict(use_kernel=use_kernel)
    h = _maxpool(F.relu(_conv2d(x, params["c1"], ncfg, **kw)))
    h = _maxpool(F.relu(_conv2d(h, params["c2"], ncfg, **kw)))
    h = h.reshape(h.shape[0], -1)
    h = F.relu(nmatmul(h, params["f1"], ncfg, out_dtype=torch.float32, **kw) + params["b1"])
    h = F.relu(nmatmul(h, params["f2"], ncfg, out_dtype=torch.float32, **kw) + params["b2"])
    return nmatmul(h, params["f3"], ncfg, out_dtype=torch.float32, **kw) + params["b3"]


# ---------------------------------------------------------------------------
# CifarNet (CIFAR-10 row)
# ---------------------------------------------------------------------------

def cifarnet_init(generator: torch.Generator, in_ch: int = 3, n_classes: int = 10,
                  hw: int = 32) -> Params:
    kw = dict(generator=generator, device=generator.device)
    flat = (hw // 4) * (hw // 4) * 64
    p = {
        "c1": dense_init(5 * 5 * in_ch, 32, **kw).reshape(5, 5, in_ch, 32),
        "c2": dense_init(5 * 5 * 32, 64, **kw).reshape(5, 5, 32, 64),
        "f1": dense_init(flat, 384, **kw),
        "f2": dense_init(384, n_classes, **kw),
    }
    p.update(b1=_zeros(384, p["c1"]), b2=_zeros(n_classes, p["c1"]))
    return p


def cifarnet_apply(params: Params, x, ncfg: NumericsConfig,
                   use_kernel: Optional[bool] = None):
    kw = dict(use_kernel=use_kernel)
    h = _maxpool(F.relu(_conv2d(x, params["c1"], ncfg, **kw)))
    h = _maxpool(F.relu(_conv2d(h, params["c2"], ncfg, **kw)))
    h = h.reshape(h.shape[0], -1)
    h = F.relu(nmatmul(h, params["f1"], ncfg, out_dtype=torch.float32, **kw) + params["b1"])
    return nmatmul(h, params["f2"], ncfg, out_dtype=torch.float32, **kw) + params["b2"]


# ---------------------------------------------------------------------------
# training / eval harness
# ---------------------------------------------------------------------------

def xent(logits, y):
    return torch.mean(torch.logsumexp(logits, dim=-1)
                      - torch.gather(logits, -1, y[:, None].to(torch.long))[:, 0])


def train_classifier(init_fn: Callable[[torch.Generator], Params], apply_fn, x, y, *,
                     epochs: int = 10, batch: int = 128, lr: float = 1e-3, seed: int = 0,
                     ncfg: NumericsConfig = NumericsConfig(mode="f32"), device=None,
                     use_kernel: Optional[bool] = None) -> Params:
    """Adam training in the given numerics mode (the paper also trains
    posit16 models in posit arithmetic), on ``device`` (CUDA by default).

    ``init_fn`` takes a ``torch.Generator`` seeded with ``seed`` on the
    device; each epoch's order is a ``torch.randperm`` from a generator
    seeded with ``seed + 1``.  x, y are numpy arrays.
    """
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in init_fn(gen).items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    xt = torch.as_tensor(np.asarray(x), device=device)
    yt = torch.as_tensor(np.asarray(y), device=device)
    order_gen = torch.Generator().manual_seed(seed + 1)
    names = list(params)
    n = xt.shape[0]
    t = 0
    for _ in range(epochs):
        order = torch.randperm(n, generator=order_gen).to(device)
        for i in range(0, n - batch + 1, batch):
            idx = order[i:i + batch]
            t += 1
            loss = xent(apply_fn(params, xt[idx], ncfg, use_kernel=use_kernel), yt[idx])
            # plam_sim's products carry no gradient: the reference's zero
            grads = (torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
                     if loss.requires_grad else [None] * len(names))
            grads = [torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(names, grads)]
            tf = torch.tensor(float(t), dtype=torch.float32)
            bc1 = (1 - torch.tensor(0.9, dtype=torch.float32) ** tf).to(device)
            bc2 = (1 - torch.tensor(0.999, dtype=torch.float32) ** tf).to(device)
            with torch.no_grad():
                for k, g in zip(names, grads):
                    m[k] = 0.9 * m[k] + 0.1 * g
                    v[k] = 0.999 * v[k] + 0.001 * g * g
                    params[k].sub_(lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + 1e-8))
    return {k: p.detach() for k, p in params.items()}


@torch.no_grad()
def accuracy(apply_fn, params: Params, x, y, ncfg: NumericsConfig, batch: int = 512,
             topk=(1,), use_kernel: Optional[bool] = None):
    """Top-k accuracy for each k in ``topk``, over numpy x, y, on the
    parameters' device; logits ranked by a stable descending sort."""
    device = next(iter(params.values())).device
    correct = {k: 0 for k in topk}
    n = x.shape[0]
    for i in range(0, n, batch):
        xb = torch.as_tensor(np.asarray(x[i:i + batch]), device=device)
        yb = torch.as_tensor(np.asarray(y[i:i + batch]), device=device)
        logits = apply_fn(params, xb, ncfg, use_kernel=use_kernel)
        rank = torch.argsort(-logits, dim=-1, stable=True)
        for k in topk:
            correct[k] += int(torch.sum(torch.any(rank[:, :k] == yb[:, None], dim=1)))
    return {k: c / n for k, c in correct.items()}
