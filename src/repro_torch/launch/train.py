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
"""
import argparse
import dataclasses


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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the kernels' "
                         "plain versions)")
    return ap


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import MODEL_CLASSES
    from repro_torch.core.modes import NumericsConfig
    from repro_torch.core.policy import describe, load_policy_arg
    from repro_torch.data.synthetic import DataConfig, lm_batch
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import set_trainable
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train.checkpoint import policy_extra
    from repro_torch.train.loop import FailureInjector, TrainConfig, run

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")
    if args.numerics_policy is not None:
        cfg = cfg.with_numerics(load_policy_arg(args.numerics_policy))
    else:
        cfg = cfg.with_numerics(NumericsConfig(
            mode=args.numerics, n=args.posit_n, es=args.posit_es, carrier=args.carrier))
    api = build(cfg)

    def init():
        return set_trainable(api.init(seed=0, device=device))

    shapes = MODEL_CLASSES[cfg.family](cfg, generator=torch.Generator(),
                                       device=torch.device("meta"))
    n_params = sum(p.numel() for p in shapes.parameters())
    print(f"arch={cfg.name}{' (reduced)' if args.reduced else ''} "
          f"params={n_params / 1e6:.1f}M numerics={describe(cfg.numerics)!r}")
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit("use examples/ for multimodal training demos; LM families here")

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
    )
    for s, loss in info["history"]:
        print(f"step {s:5d}  loss {loss:.4f}")
    print(f"restarts={info['restarts']} final_step={info['final_step']}")


if __name__ == "__main__":
    main()
