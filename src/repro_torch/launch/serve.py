"""Serving CLI: batched generation under any numerics mode/policy.

Port of ``repro/launch/serve.py``.  On the card::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --continuous \
      --prequantized --numerics-policy "default=plam_sim:16:1" --batch 4 \
      --prompt-len 64 --new-tokens 16

and on the CPU (the kernels' plain versions) with ``--device cpu``,
usually with ``--reduced``.  Without ``--device`` it runs on CUDA and
raises when there is no card.

``--numerics-policy`` takes a per-site policy string (e.g.
``"default=plam_sim:16:1, attn=posit_quant:16:1, lm_head=f32"``) or the
path to a saved policy artifact.  ``--prequantized`` encodes
policy-selected weights to posit patterns once at engine build (int16
storage; PLAM sites serve through ``kernels.ops.plam_dense``).

``--continuous`` serves on the paged-KV continuous-batching engine,
staggering request arrivals one step apart; it is the only engine ported
so far, so a run without it raises ``NotImplementedError``, as do
``--tp N`` (N > 1) and ``--force-host-devices`` (``ROADMAP.md``, queue
1, items 11 and 12).  ``--prefill-chunk M`` turns on chunked prefill (M
a multiple of the block size, 8).

Engine options beyond those flags are spelled ``--opt KEY=VAL``
(repeatable), with KEY any ``repro_torch.serving.ServeOptions`` field,
e.g. ``--opt spec_k=4 --opt preemption=recompute`` or ``--opt
prefix_cache=true``.  The old split spellings (``--numerics``,
``--spec-k``, ``--spec-draft``, ``--preemption``, ``--priority``,
``--deadline-s``) still work: using any of them emits ONE consolidated
DeprecationWarning and gives the same ``ServeOptions``.

Observability: tracing is on by default; ``--trace-out PATH`` writes the
engine trace after the run (Chrome trace_event JSON when PATH ends in
``.json``, to load in Perfetto; JSON-lines otherwise), ``--metrics-out
PATH`` a Prometheus text snapshot, and ``--profile`` wraps each engine
phase's launches in a ``torch.profiler.record_function`` span (visible
inside a ``torch.profiler`` capture).  ``python -m
repro_torch.serving.observability trace.jsonl --prom metrics.prom``
checks the files.
"""
import argparse
import dataclasses
import warnings

# legacy flag -> (ServeOptions field it maps to, dest on the parsed args)
_LEGACY_FLAGS = {
    "--spec-k": ("spec_k", "spec_k"),
    "--spec-draft": ("spec_draft", "spec_draft"),
    "--preemption": ("preemption", "preemption"),
    "--priority": ("priority", "priority"),
    "--deadline-s": ("deadline_s", "deadline_s"),
}


def make_parser() -> argparse.ArgumentParser:
    """The CLI surface: the reference's flags and defaults, and
    ``--device``."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--numerics", default=None,
                    choices=["f32", "bf16", "posit_quant", "plam_sim",
                             "mitchell_f32"],
                    help="DEPRECATED sugar for --numerics-policy "
                         "'default=<mode>'")
    ap.add_argument("--numerics-policy", default=None,
                    help="per-site policy string or path to a saved policy "
                         "artifact (default: 'default=plam_sim')")
    ap.add_argument("--prequantized", action="store_true",
                    help="encode policy-selected weights to posit patterns "
                         "once at engine build (serving-time weight storage)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="paged-KV continuous batching (the only engine "
                         "ported so far)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ways (not ported: > 1 raises)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill width (0 = whole-prompt; "
                         "must be a multiple of the block size, 8)")
    ap.add_argument("--opt", action="append", default=[], metavar="KEY=VAL",
                    help="set any repro_torch.serving.ServeOptions field, e.g. "
                         "--opt spec_k=4 --opt preemption=recompute "
                         "(repeatable; applied after first-class flags)")
    # -- deprecated split spellings (use --opt) ---------------------------
    ap.add_argument("--spec-k", type=int, default=None,
                    help="DEPRECATED: use --opt spec_k=K")
    ap.add_argument("--spec-draft", default=None,
                    help="DEPRECATED: use --opt spec_draft=SPEC")
    ap.add_argument("--preemption", default=None,
                    choices=["off", "recompute"],
                    help="DEPRECATED: use --opt preemption=MODE")
    ap.add_argument("--priority", type=int, default=None,
                    help="DEPRECATED: use --opt priority=P")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="DEPRECATED: use --opt deadline_s=S")
    # -- observability ----------------------------------------------------
    ap.add_argument("--trace-out", default=None,
                    help="write the engine trace here after the run: Chrome "
                         "trace_event JSON when the path ends in .json "
                         "(open in Perfetto), JSON-lines otherwise")
    ap.add_argument("--metrics-out", default=None,
                    help="write a Prometheus text-format metrics snapshot "
                         "here after the run")
    ap.add_argument("--profile", action="store_true",
                    help="wrap engine phases in torch.profiler.record_function "
                         "spans (visible inside a profiler capture)")
    ap.add_argument("--force-host-devices", type=int, default=0,
                    help="the reference's forced multi-device CPU platform for "
                         "tensor parallelism (not ported: > 0 raises)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the kernels' "
                         "plain versions)")
    return ap


def _coerce(field, raw: str):
    """Parse an --opt VAL string against a ServeOptions dataclass field."""
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    for conv in (int, float):
        try:
            return conv(raw)
        except ValueError:
            continue
    return raw


def options_from_args(args):
    """Build the run's ServeOptions from parsed args.

    The deprecated split flags are folded in first (emitting ONE
    consolidated DeprecationWarning naming every legacy flag used), then
    ``--opt KEY=VAL`` overrides are applied on top, so the legacy
    spelling and its --opt replacement give identical options.
    """
    from repro_torch.serving import ServeOptions

    legacy_used = []
    legacy_vals = {}
    for flag, (field, dest) in _LEGACY_FLAGS.items():
        val = getattr(args, dest)
        if val is not None:
            legacy_used.append(f"{flag} -> --opt {field}=...")
            legacy_vals[field] = val
    if args.numerics is not None:
        legacy_used.append("--numerics -> --numerics-policy 'default=<mode>'")
    if legacy_used:
        warnings.warn(
            "deprecated serve flags: " + "; ".join(sorted(legacy_used))
            + ". These spellings keep working (identical behavior via "
            "repro_torch.serving.ServeOptions) but will be removed; switch to "
            "the replacements shown.",
            DeprecationWarning,
            stacklevel=2,
        )

    max_seq = args.prompt_len + args.new_tokens
    opts = ServeOptions(
        max_new_tokens=args.new_tokens,
        temperature=args.temperature,
        seed=args.seed,
        engine="continuous" if args.continuous else "static",
        block_size=8,
        num_blocks=4 * args.batch * (max_seq // 8 + 2),
        max_slots=args.batch,
        max_seq_len=max_seq + 8,
        tp=args.tp,
        prefill_chunk=args.prefill_chunk,
        prequantize=args.prequantized,
        profile=args.profile,
        **legacy_vals,
    )
    fields = {f.name: f for f in dataclasses.fields(ServeOptions)}
    overrides = {}
    for kv in args.opt:
        key, sep, raw = kv.partition("=")
        if not sep or key not in fields:
            raise SystemExit(
                f"bad --opt {kv!r}: expected KEY=VAL with KEY a ServeOptions "
                f"field ({', '.join(sorted(fields))})")
        overrides[key] = _coerce(fields[key], raw)
    return dataclasses.replace(opts, **overrides)


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)

    import numpy as np

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.core.policy import describe, load_policy_arg, parse_policy
    from repro_torch.device import resolve_device
    from repro_torch.serving import build_engine
    from repro_torch.serving.api import LATER, TENSOR_PARALLELISM

    if args.force_host_devices:
        raise NotImplementedError(
            "--force-host-devices (a multi-device platform for tensor parallelism) "
            + LATER.format(TENSOR_PARALLELISM))
    opts = options_from_args(args)
    opts.check_supported()  # tp > 1 and the static engine raise here
    device = resolve_device(args.device)

    if args.arch not in ARCHS:
        raise SystemExit(f"unknown arch {args.arch!r}; pick from {sorted(ARCHS)}")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), param_dtype="float32",
                                  act_dtype="float32")
    if args.numerics_policy is not None:
        policy = load_policy_arg(args.numerics_policy)
    else:  # single-mode default (or deprecated --numerics sugar)
        policy = parse_policy(f"default={args.numerics or 'plam_sim'}")
    cfg = cfg.with_numerics(policy)
    numerics_label = describe(cfg.numerics)

    rng = np.random.default_rng(args.seed)
    eng = build_engine(cfg, opts, init_seed=args.seed, device=device)
    handles = [eng.submit(rng.integers(0, cfg.vocab, args.prompt_len).tolist(),
                          arrival_step=i, **opts.submit_kwargs())
               for i in range(args.batch)]
    done = eng.run()
    spec = (f" spec_k={opts.spec_k} "
            f"accept={eng.stats.acceptance_rate():.1%} "
            f"tok/verify={eng.stats.tokens_per_verify_step():.2f}"
            if opts.spec_k else "")
    if opts.preemption != "off" or opts.deadline_s is not None:
        spec += (f" preemptions={eng.stats.preemptions}"
                 f" resumes={eng.stats.resumes}"
                 f" deadline_cancelled={eng.stats.deadline_cancelled}")
    if opts.prefix_cache:
        al = eng.allocator
        spec += (f" prefix_hits={al.hits} prefix_misses={al.misses}"
                 f" prefill_tokens_saved={al.tokens_saved}"
                 f" prefix_evictions={al.evictions}")
    print(f"arch={cfg.name} numerics={numerics_label!r} engine=continuous "
          f"tp={opts.tp} prefill_chunk={opts.prefill_chunk} "
          f"steps={eng.stats.steps} pad_waste={eng.stats.padding_waste():.1%} "
          f"step_p50={eng.stats.latency_p50() * 1e3:.1f}ms "
          f"step_p95={eng.stats.latency_p95() * 1e3:.1f}ms" + spec)
    for i, h in enumerate(handles):
        print(f"req[{i}]: {done[h.rid]}")
        bd = h.breakdown()
        if bd is not None:
            print(f"  queue={bd.queue_s * 1e3:.1f}ms "
                  f"prefill={bd.prefill_s * 1e3:.1f}ms "
                  f"decode={bd.decode_s * 1e3:.1f}ms "
                  f"parked={bd.parked_s * 1e3:.1f}ms "
                  f"ttft={bd.first_token_s * 1e3:.1f}ms")
    _write_artifacts(args, eng)


def _write_artifacts(args, eng) -> None:
    """Honor --trace-out / --metrics-out after a run."""
    if args.trace_out:
        if eng.trace is None:
            print(f"trace-out skipped: engine has no trace (trace=False): "
                  f"{args.trace_out}")
        elif args.trace_out.endswith(".json"):
            eng.trace.to_chrome_trace(args.trace_out)
            print(f"wrote Chrome trace: {args.trace_out}")
        else:
            eng.trace.to_jsonl(args.trace_out)
            print(f"wrote trace events: {args.trace_out}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(eng.metrics.to_prometheus_text())
        print(f"wrote metrics: {args.metrics_out}")


if __name__ == "__main__":
    main()
