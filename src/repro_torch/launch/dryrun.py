"""Dry run of every (arch x shape) cell on one H100, without the card
(port of ``repro/launch/dryrun.py``).

For each cell this builds the model as ``init`` gives it and the step's
inputs (``train_inputs``, ``prefill_inputs`` or ``decode_inputs``; for
training, ``train_loss``, its backward and one AdamW step of
``optim/optimizers.py``) on the meta device, where a tensor has a shape,
a dtype and no bytes -- the reference's ``jax.eval_shape`` -- and runs
the step once under the op-level analysis (``launch/op_analysis.py``).
The kernels take their path on meta (``kernels/_lib.py::launch``): each
launch is counted and its work recorded, and nothing is built or run.
It writes ``<arch>__<shape>__1.json`` with

  * the analysis: matmul FLOPs (and by class), ``elem_ops``,
    ``bytes_accessed``, the kernels' integer operations and work by name,
    collectives (none on one card)
  * ``launches``: the kernel launches of the step, as the card counts them
  * ``memory``: ``argument_bytes`` (parameters, optimizer state, inputs),
    ``output_bytes`` (what the step leaves alive), ``temp_bytes`` (the peak
    of the step's own storages, outputs aside), ``peak_bytes`` (arguments
    plus that peak), ``device_bytes`` (the card's, or the data sheet's 80
    GB without one: ``device_bytes_source`` says which) and ``fits``
  * ``trace_s``, the wall seconds of the build and the traced step (the
    reference's ``lower_s`` and ``compile_s``)

and archives the op trace beside it (``<stem>.ops.jsonl.gz``, which
``roofline.py --reanalyze`` re-aggregates).  Cells that do not apply
(quadratic attention at 524k tokens) get a record with ``skipped``.
A meta run touches no card and allocates no model's bytes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--numerics plam_sim]

``--numerics-policy`` runs the cells under a per-site numerics policy
(string or saved-artifact path); ``--numerics`` is the single-mode sugar
for ``default=<mode>``; ``--prequantized`` encodes the policy's posit
weights to patterns first, as the serving engines' ``prequantize`` does.
The reference's ``--multi-pod`` mesh is a data-parallel training mesh,
which waits for the sharded dry run (``ROADMAP.md``, queue 1, item 8b).
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import time

import torch

from repro_torch.configs import ARCHS, ALL_SHAPES, applicable_shapes, get_config, shape_by_name
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.policy import as_policy, describe, load_policy_arg, parse_policy, policy_to_str
from repro_torch.kernels import _lib
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.launch.roofline import HBM_BYTES
from repro_torch.models.registry import build
from repro_torch.models.transformer import set_trainable
from repro_torch.optim.optimizers import OptConfig, init_state
from repro_torch.train.loop import TrainConfig, make_train_step

SKIPPED = "quadratic attention at 524k tokens (the config is not sub_quadratic)"


def _materialize(spec, cfg: ModelConfig, device):
    """The inputs a spec of meta tensors describes, on ``device``: on meta
    the spec itself; else integer tensors drawn below the vocabulary,
    float ones N(0, 1), from a generator seeded with 1, caches zero (a
    host int stays as it is)."""
    if device.type == "meta":
        return spec
    gen = torch.Generator(device=device).manual_seed(1)

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(one(v) for v in t)
        if not isinstance(t, torch.Tensor):
            return t
        if not t.is_floating_point():
            return torch.randint(0, cfg.vocab, t.shape, generator=gen, device=device,
                                 dtype=t.dtype)
        return torch.randn(t.shape, generator=gen, device=device).to(t.dtype)

    out = {k: one(v) for k, v in spec.items()}
    for key in ("kv_caches", "caches"):  # a cache starts at zero
        if key in out:
            out[key] = _zeroed(out[key])
    return out


def _zeroed(tree):
    if isinstance(tree, dict):
        return {k: _zeroed(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zeroed(v) for v in tree)
    return tree.zero_()


def build_cell(cfg: ModelConfig, shape: ShapeSpec, *, device="meta", prequantize=False):
    """Returns (step, args) for one cell: ``step(*args)`` runs it.  On
    ``"meta"`` (the default) nothing is allocated; on a card the same
    step runs on seeded weights and inputs (``chip_smoke.py``'s phase
    ``dryrun`` holds the two against each other)."""
    device = torch.device(device)
    api = build(cfg)
    model = api.init(0, device=device)
    if prequantize:
        from repro_torch.core.prequant import quantize_params

        quantize_params(cfg, model)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        set_trainable(model)
        batch = _materialize(api.train_inputs(b, s), cfg, device)
        ocfg = OptConfig(name="adamw", lr=1e-4)
        opt = init_state(ocfg, model)
        step = make_train_step(api.train_loss, TrainConfig(opt=ocfg))
        return step, (model, opt, batch)
    if shape.kind == "prefill":
        return api.prefill, (model, _materialize(api.prefill_inputs(b, s), cfg, device))
    if shape.kind == "decode":
        return api.decode_step, (model, _materialize(api.decode_inputs(b, s), cfg, device))
    raise ValueError(f"unknown shape kind {shape.kind!r}")


def _storages(tree) -> dict:
    """Distinct storages of the tensors in ``tree`` (modules' parameters
    and buffers included): id -> bytes."""
    out = {}

    def visit(t):
        if isinstance(t, torch.nn.Module):
            for p in (*t.parameters(), *t.buffers()):
                visit(p)
        elif isinstance(t, dict):
            for v in t.values():
                visit(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                visit(v)
        elif isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()

    visit(tree)
    return out


def device_bytes():
    """(bytes, source): the card's memory where one is present, else the
    data sheet's 80 GB."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory, "card"
    return HBM_BYTES, "data sheet (no card)"


def trace_step(step, args):
    """Run ``step(*args)`` once under the op analysis.  Returns (analysis,
    the launches of the step by kernel, its outputs)."""
    before = dict(_lib.launches)
    with OpAnalysis() as oa:
        out = step(*args)
    launches = {k: v - before[k] for k, v in _lib.launches.items() if v != before[k]}
    return oa.result, launches, out


def analyze_cell(cfg: ModelConfig, shape: ShapeSpec, *, prequantize=False, tag="",
                 warmup=False):
    """The dry-run record of one cell, and its analysis.  ``warmup`` runs the step once untraced first, as a process
    that has run it before would (its K3 tables built: the card's step
    after a warm-up)."""
    t0 = time.time()
    step, args = build_cell(cfg, shape, prequantize=prequantize)
    if warmup:
        step(*args)
    ana, launches, out = trace_step(step, args)
    trace_s = time.time() - t0
    arg_bytes = float(sum(_storages(args).values()))
    dev_bytes, dev_src = device_bytes()
    peak = arg_bytes + ana.peak_live_bytes
    del out
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "mesh": "1",
        "devices": 1,
        **ana.record_fields(),
        "launches": launches,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": ana.end_live_bytes,
            "temp_bytes": ana.peak_live_bytes - ana.end_live_bytes,
            "peak_bytes": peak,
            "device_bytes": float(dev_bytes),
            "device_bytes_source": dev_src,
            "fits": peak <= dev_bytes,
        },
        "trace_s": round(trace_s, 2),
        "numerics": describe(cfg.numerics),
        "numerics_policy": policy_to_str(as_policy(cfg.numerics)),
        "prequantized": bool(prequantize),
        "tag": tag,
    }, ana


def run_cell(arch: str, shape_name: str, *, out_dir="build/dryrun", cfg_override=None,
             tag="", prequantize=False):
    cfg = cfg_override or get_config(arch)
    shape = shape_by_name(shape_name)
    stem = f"{arch}__{shape_name}__1{('__' + tag) if tag else ''}"
    os.makedirs(out_dir, exist_ok=True)
    if shape not in applicable_shapes(cfg):
        rec = {"arch": arch, "shape": shape_name, "mesh": "1", "skipped": SKIPPED}
        ana = None
    else:
        rec, ana = analyze_cell(cfg, shape, prequantize=prequantize, tag=tag)
        rec["arch"] = arch
    with open(os.path.join(out_dir, stem + ".json"), "w") as f:
        json.dump(rec, f, indent=2)
    if ana is not None:
        # the op trace, so the analysis can be re-aggregated offline
        with gzip.open(os.path.join(out_dir, stem + ".ops.jsonl.gz"), "wt") as f:
            for op in ana.ops:
                f.write(json.dumps(op) + "\n")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 2-pod mesh (not ported: raises)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="build/dryrun")
    ap.add_argument("--numerics", default=None,
                    choices=["f32", "bf16", "posit_quant", "plam_sim", "mitchell_f32"],
                    help="uniform mode; sugar for --numerics-policy 'default=<mode>'")
    ap.add_argument("--numerics-policy", default=None,
                    help="per-site policy string or saved-artifact path")
    ap.add_argument("--prequantized", action="store_true",
                    help="encode the policy's posit weights to patterns before the step")
    args = ap.parse_args(argv)
    if args.multi_pod:
        from repro_torch.launch.mesh import make_production_mesh

        make_production_mesh(multi_pod=True)  # raises, naming its ROADMAP item

    policy = None
    if args.numerics_policy is not None:
        policy = load_policy_arg(args.numerics_policy)
    elif args.numerics is not None:
        policy = parse_policy(f"default={args.numerics}")

    if args.all:
        cells = [(arch, shape.name) for arch in ARCHS for shape in ALL_SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    t_all = time.time()
    for arch, shape in cells:
        try:
            cfg_override = get_config(arch).with_numerics(policy) if policy is not None else None
            rec = run_cell(arch, shape, out_dir=args.out_dir, cfg_override=cfg_override,
                           prequantize=args.prequantized)
            if "skipped" in rec:
                print(f"[SKIP] {arch} x {shape}: {rec['skipped']}", flush=True)
                continue
            mem = rec["memory"]
            print(f"[OK] {arch} x {shape}: flops={rec['flops']:.3e} "
                  f"int_ops={rec['int_ops']:.3e} bytes={rec['bytes_accessed']:.3e} "
                  f"peak={mem['peak_bytes'] / 1e9:.2f}GB fits={mem['fits']} "
                  f"launches={rec['launches']} trace={rec['trace_s']}s", flush=True)
        except Exception as e:  # noqa: BLE001 - a failing cell is a bug to surface
            print(f"[FAIL] {arch} x {shape}: {type(e).__name__}: {e}", flush=True)
            raise
    print(f"{len(cells)} cells in {time.time() - t_all:.1f} s", flush=True)


if __name__ == "__main__":
    main()
