"""Deterministic synthetic data pipeline (port of ``repro/data/synthetic.py``).

Streams are stateless: a batch is a pure function of (seed, step), so a
restarted run regenerates exactly the same batch without any storage,
which is what makes checkpoint-restart replay free.

``lm_batch`` keeps the reference's structure (a fixed permutation chain
with 10% uniform noise) but draws from numpy's ``Generator`` seeded with
``SeedSequence([seed, step])``, not from JAX's threefry: the same
structure, other bits.  ``classification_dataset`` and ``image_dataset``
are numpy in the reference too and are copied bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 512
    seq_len: int = 128
    global_batch: int = 8


def lm_batch(cfg: DataConfig, step: int):
    """Global LM batch for ``step``: {"tokens", "labels"}, int32 [B, S]
    CPU tensors.

    A Markov-ish synthetic language: token t+1 is ``perm[token t]`` for a
    fixed random permutation (from ``seed + 7``), or with probability 0.1
    a uniform draw, so a model can learn structure.  ``labels`` is the
    chain and ``tokens`` the first token followed by the chain shifted by
    one, so labels are the next tokens.
    """
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab
    perm = np.random.default_rng(cfg.seed + 7).permutation(v)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    first = rng.integers(0, v, (b, 1))
    noise = rng.random((b, s)) < 0.1
    rand = rng.integers(0, v, (b, s))
    chain = np.empty((b, s), np.int64)
    tok = first[:, 0]
    for t in range(s):
        tok = np.where(noise[:, t], rand[:, t], perm[tok])
        chain[:, t] = tok
    tokens = np.concatenate([first, chain[:, :-1]], axis=1).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(chain.astype(np.int32))}


def classification_dataset(seed: int, n: int, d_in: int, n_classes: int, *,
                           margin: float = 4.0):
    """Gaussian-cluster classification data (ISOLET/HAR stand-ins).

    Returns (x [n, d_in] f32, y [n] i32) as numpy.  Class centers are
    random unit vectors scaled by ``margin``; inputs add noise.
    """
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_classes, d_in)).astype(np.float32)
    centers *= margin / np.linalg.norm(centers, axis=1, keepdims=True)
    y = rng.integers(0, n_classes, n)
    x = centers[y] + rng.standard_normal((n, d_in)).astype(np.float32) * 0.8
    return x.astype(np.float32), y.astype(np.int32)


def image_dataset(seed: int, n: int, hw: int, channels: int, n_classes: int):
    """Synthetic image classification (MNIST/SVHN/CIFAR stand-ins):
    class-dependent frequency gratings + noise, numpy [n, hw, hw, c] f32
    and [n] i32."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    xs = np.linspace(0, np.pi * 2, hw, dtype=np.float32)
    xx, yy = np.meshgrid(xs, xs)
    imgs = np.empty((n, hw, hw, channels), np.float32)
    for c in range(n_classes):
        idx = np.where(y == c)[0]
        freq = 1.0 + c * 0.25
        phase = rng.uniform(0, np.pi, (len(idx), 1, 1))
        base = np.sin(freq * xx)[None] + np.cos(freq * yy)[None] + phase
        for ch in range(channels):
            imgs[idx, :, :, ch] = base + rng.standard_normal((len(idx), hw, hw)) * 3.0
    return imgs * 0.25, y.astype(np.int32)
