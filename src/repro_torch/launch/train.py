"""Training CLI: the port's LM archs (reduced or full), any numerics.

Port of ``repro/launch/train.py``.  On the CPU (the kernels' plain
versions), reduced, posit16, fault-tolerant::

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \
      --steps 50 --numerics posit_quant --ckpt-dir ck --simulate-failure 30 \
      --device cpu

Without ``--device`` it runs on CUDA and raises when there is no card.
``--numerics-policy`` trains under a per-site policy (string or saved
artifact); the policy goes into every checkpoint manifest, so serving
restores the exact numerics.  The single-mode flags (--numerics,
--posit-n, --posit-es, --carrier) stay as sugar for a uniform policy.
Checkpoints use the reference's layout, so either package resumes the
other's.  It trains the dense, MoE, ssm and hybrid archs; an encdec or
vlm arch prints its parameter count and exits pointing at ``examples/``,
as the reference's CLI does (their ``train_loss`` is the registry's).

``--data N --model M`` trains the dense, MoE, ssm and hybrid archs over a mesh of
N x M ranks started by ``launch/mesh.py::spawn`` (tensor parallelism
over ``model``, the global batch split over ``data``, ZeRO-1 AdamW
state; ``train/loop.py``), over ``nccl`` when every rank has a card of
its own and ``gloo`` when they share one or run on the CPU; rank 0's
lines are printed, and the checkpoints hold whole leaves, so any mesh
resumes them.  ``--force-host-devices K`` runs the ranks on the CPU, as
the serve CLI's does (N x M may not exceed K).  The reference's driver
has no such flags: there one process drives every device, and "on a
real cluster the same entry point runs the full config against the
production mesh"; the port runs one process a rank::

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \
      --steps 4 --data 2 --model 2 --force-host-devices 4 --device cpu \
      --ckpt-dir ck --ckpt-every 2 --simulate-failure 3
"""
import argparse
import dataclasses
import os


def make_parser() -> argparse.ArgumentParser:
    from repro_torch.configs import ARCHS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--numerics", default="posit_quant",
                    choices=["f32", "bf16", "posit_quant", "plam_sim", "mitchell_f32"],
                    help="uniform mode; sugar for --numerics-policy 'default=<mode>'")
    ap.add_argument("--numerics-policy", default=None,
                    help="per-site policy string or saved-artifact path "
                         "(overrides the single-mode flags)")
    ap.add_argument("--posit-n", type=int, default=16)
    ap.add_argument("--posit-es", type=int, default=1)
    ap.add_argument("--carrier", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--opt", default="adamw", choices=["adamw", "adam", "sgd", "nesterov"])
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel ranks (the global batch split over them)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel ranks (dense, moe, ssm and hybrid archs)")
    ap.add_argument("--force-host-devices", type=int, default=0,
                    help="run on K host (CPU) devices: the ranks run on the CPU and "
                         "--data x --model may not exceed K")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the kernels' "
                         "plain versions)")
    return ap


def _config(args):
    from repro_torch.configs import get_config
    from repro_torch.core.modes import NumericsConfig
    from repro_torch.core.policy import load_policy_arg

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")
    if args.numerics_policy is not None:
        return cfg.with_numerics(load_policy_arg(args.numerics_policy))
    return cfg.with_numerics(NumericsConfig(
        mode=args.numerics, n=args.posit_n, es=args.posit_es, carrier=args.carrier))


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)

    import torch

    from repro_torch.convert import MODEL_CLASSES
    from repro_torch.core.policy import describe
    from repro_torch.device import resolve_device

    world = args.data * args.model
    if args.force_host_devices:
        if args.device not in (None, "cpu"):
            raise SystemExit("--force-host-devices runs on host devices; drop --device")
        if world > args.force_host_devices:
            raise SystemExit(f"a mesh of data={args.data} x model={args.model} needs {world} "
                             f"ranks/devices, found {args.force_host_devices} host devices")
        args.device = "cpu"
    cfg = _config(args)
    shapes = MODEL_CLASSES[cfg.family](cfg, generator=torch.Generator(),
                                       device=torch.device("meta"))
    n_params = sum(p.numel() for p in shapes.parameters())
    print(f"arch={cfg.name}{' (reduced)' if args.reduced else ''} "
          f"params={n_params / 1e6:.1f}M numerics={describe(cfg.numerics)!r}")
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit("use examples/ for multimodal training demos; LM families here")
    if world > 1:
        from repro_torch.launch.mesh import spawn
        from repro_torch.parallel.sharding import check_shardable

        try:
            check_shardable(cfg, args.model)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        if args.batch % (args.data * args.grad_accum):
            raise SystemExit(f"--batch {args.batch} does not split into --grad-accum "
                             f"{args.grad_accum} micro-batches over --data {args.data}")
        # CPU ranks share the host's cores rather than each taking all of them
        threads = (max(1, (os.cpu_count() or 1) // world)
                   if torch.device(args.device or "cuda").type == "cpu" else None)
        lines = spawn(_train_rank, world, args.device, args, threads=threads)[0]
    else:
        lines = _train(args, resolve_device(args.device))
    for line in lines:
        print(line)


def _train_rank(device, args) -> list:
    """One rank of a ``--data``/``--model`` run (``launch/mesh.py::spawn``):
    its lines (rank 0's are printed)."""
    from repro_torch.launch.mesh import make_host_mesh

    return _train(args, device, make_host_mesh(data=args.data, model=args.model))


def _train(args, device, mesh=None) -> list:
    """Train the CLI's run on ``device`` (under ``mesh``, this rank's
    shard); returns the lines to print."""
    from repro_torch.data.synthetic import DataConfig, lm_batch
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import set_trainable
    from repro_torch.optim.optimizers import OptConfig, Zero1
    from repro_torch.parallel.sharding import leaf_layouts
    from repro_torch.train.checkpoint import policy_extra
    from repro_torch.train.loop import FailureInjector, TrainConfig, run

    cfg = _config(args)
    api = build(cfg)
    zero = None if mesh is None else Zero1(leaf_layouts(cfg, mesh), mesh)

    def init():
        if mesh is None:
            return set_trainable(api.init(seed=0, device=device))
        return set_trainable(api.init(seed=0, device=device, mesh=mesh))

    dcfg = DataConfig(seed=0, vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.batch)
    tcfg = TrainConfig(
        opt=OptConfig(name=args.opt, lr=args.lr),
        grad_accum=args.grad_accum,
        compress_grads=args.compress_grads,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        ckpt_extra=policy_extra(cfg.numerics),
    )
    failure = FailureInjector([args.simulate_failure]) if args.simulate_failure else None
    _, _, info = run(
        loss_fn=api.train_loss,
        init_params_fn=init,
        batch_fn=lambda s: lm_batch(dcfg, s),
        tcfg=tcfg,
        num_steps=args.steps,
        failure=failure,
        zero=zero,
    )
    lines = [f"step {s:5d}  loss {loss:.4f}" for s, loss in info["history"]]
    lines.append(f"restarts={info['restarts']} final_step={info['final_step']}")
    return lines


if __name__ == "__main__":
    main()
