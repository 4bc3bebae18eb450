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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.convert import load_named, named_tree
from repro_torch.optim.optimizers import OptConfig, apply_updates, init_state, named_params

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


def _int8_compress(g: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Stochastic-rounded int8 quantization of a gradient tensor, in f32.

    Models compressed gradient exchange (the all-reduce would move 1/4
    of the bytes).  Unbiased: E[result] == g.
    """
    g = g.to(torch.float32)
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    noise = torch.rand(g.shape, generator=generator, device=g.device) - 0.5
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def _compress_generator(step: int, device) -> torch.Generator:
    seed = np.random.SeedSequence([17, step]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


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


def make_train_step(loss_fn: Callable, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics), updating params and state in place.

    With grad_accum > 1 the batch is split on its leading axis into
    micro-batches whose f32 gradients are summed (activation memory
    drops by the accumulation factor).
    """

    def train_step(params, opt_state, batch):
        named = named_params(params)
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
            grads = {n: None if g is None else g / tcfg.grad_accum for n, g in grads.items()}
        else:
            loss, grads = _grads(loss_fn, params, named, batch)

        if tcfg.compress_grads:
            gen = None
            for n, g in grads.items():
                if g is not None:
                    gen = gen or _compress_generator(int(opt_state["step"]), g.device)
                    grads[n] = _int8_compress(g, gen)

        apply_updates(tcfg.opt, params, grads, opt_state)
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
):
    """Drive training with checkpoint/restart.  On an (injected) step
    failure the loop restores the last checkpoint and continues; the data
    pipeline is stateless, so batches replay identically."""
    step_fn = make_train_step(loss_fn, tcfg)

    def fresh():
        params = init_params_fn()
        return params, init_state(tcfg.opt, params), 0

    def restore_into(params, opt_state):
        tree, _ = ckpt_lib.restore(tcfg.ckpt_dir, train_tree(params, opt_state))
        load_train_tree(tree, params, opt_state)

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
                ckpt_lib.save(tcfg.ckpt_dir, step, train_tree(params, opt_state),
                              extra=tcfg.ckpt_extra)
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
        ckpt_lib.save(tcfg.ckpt_dir, step, train_tree(params, opt_state),
                      extra=tcfg.ckpt_extra)
    return params, opt_state, {"history": history, "restarts": restarts, "final_step": step}
