"""Dry run of every (arch x shape) cell on one H100 or one rank of a mesh
of them, without the card (port of ``repro/launch/dryrun.py``).

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

Under ``--mesh DxM`` (or ``PxDxM``) and ``--multi-pod`` (the reference's
2 x 16 x 16) each cell is one rank's step on a virtual mesh
(``launch/mesh.py::VirtualMesh``; 16 x 16 is the reference's production
mesh): rank r's shard built on meta (``init(mesh=...)``), its inputs as
the reference's ``batch_shardings`` cut them (the batch over ``data``,
which folds in ``pod``; a global batch of 1 decodes with the hybrid's
shared K/V positions over ``data``; caches over ``model``), for training
ZeRO-1 AdamW state (``optim/optimizers.py::Zero1``; the encdec's
encoder and decoder stacks each at its own depth).  The rank's
collectives are counted as the world's are (kind, axis, group, result
bytes) and each axis is priced at its link (``roofline.py::axis_link``).
The record then has ``devices``, ``mesh``, ``rank``, ``collectives``
by axis, and in ``memory`` the parameter, optimizer-state and input
bytes beside the reference rules' per-device parameter count
(``param_bytes_rules``: where kv < tp a rank keeps whole kv heads,
``parallel/sharding.py::kv_heads_for_rank``, and holds more).  Rank 0 is
analysed; where another model rank holds more argument bytes, that rank
too (``ranks``).  The encdec's ``frames`` and ``enc_out`` and the vlm's
``embeds_prefix`` are cut over the batch as its tokens are.  Two
shardings of the reference are not ported, by design: ``kv_seq_tp`` (a
decode cache's positions over ``model`` where kv < tp: no config sets
it, and the port's kv-head layout takes its place), and an encdec
decode's ``enc_out`` positions over ``data`` at a global batch of 1 (no
applicable cell has one: long_500k does not apply to a quadratic
config), which raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--numerics plam_sim]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

``--numerics-policy`` runs the cells under a per-site numerics policy
(string or saved-artifact path); ``--numerics`` is the single-mode sugar
for ``default=<mode>``; ``--prequantized`` encodes the policy's posit
weights to patterns first, as the serving engines' ``prequantize`` does.
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
from repro_torch.launch.mesh import make_production_mesh, make_virtual_mesh, mesh_name
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.launch.roofline import HBM_BYTES, axis_link
from repro_torch.models.registry import build
from repro_torch.models.transformer import set_trainable
from repro_torch.optim.optimizers import OptConfig, Zero1, init_state, zero1_dims, zero1_numel
from repro_torch.parallel.sharding import (
    check_shardable,
    leaf_layouts,
    meta_params,
    sanitize,
    spec_for_param,
    use_mesh,
)
from repro_torch.train.loop import TrainConfig, local_rows, make_train_step

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


def build_cell(cfg: ModelConfig, shape: ShapeSpec, *, device="meta", prequantize=False,
               mesh=None, inputs=None):
    """Returns (step, args) for one cell: ``step(*args)`` runs it.  On
    ``"meta"`` (the default) nothing is allocated; on a card the same
    step runs on seeded weights and inputs (``chip_smoke.py``'s phases
    ``dryrun``, ``tp_ssm`` and ``tp_encdec`` hold the two against each
    other).  Under a ``mesh`` (run the step inside ``use_mesh(mesh)``),
    rank ``mesh.rank``'s step: its shard, its inputs (:func:`rank_inputs`)
    and, for training, ZeRO-1 state; a training batch is the global one,
    which the step cuts (``train/loop.py::local_rows``), as the world's
    ranks take it.  ``inputs``: a prefill's or decode step's inputs (meta
    tensors, the rank's) in place of the shape's, for a served run whose
    shapes no ``ShapeSpec`` gives (an encdec's target prefix shorter than
    its frames)."""
    device = torch.device(device)
    api = build(cfg)
    with use_mesh(mesh):
        model = api.init(0, device=device) if mesh is None else \
            api.init(0, device=device, mesh=mesh)
        if prequantize:
            from repro_torch.core.prequant import quantize_params

            quantize_params(cfg, model)
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            set_trainable(model)
            batch = _materialize(api.train_inputs(b, s), cfg, device)
            ocfg = OptConfig(name="adamw", lr=1e-4)
            zero = None if mesh is None else Zero1(leaf_layouts(cfg, mesh), mesh)
            opt = init_state(ocfg, model, zero)
            step = make_train_step(api.train_loss, TrainConfig(opt=ocfg), zero)
            return step, (model, opt, batch)
        if inputs is None:
            inputs = rank_inputs(api, shape, mesh)
        if shape.kind == "prefill":
            return api.prefill, (model, _materialize(inputs, cfg, device))
        if shape.kind == "decode":
            return api.decode_step, (model, _materialize(inputs, cfg, device))
    raise ValueError(f"unknown shape kind {shape.kind!r}")


def rank_rows(batch: int, mesh) -> int:
    """The rows of a global batch a rank holds: its block over the batch
    axis, or all of them where the axis does not divide the batch (the
    reference's ``sanitize``, e.g. a global batch of 1)."""
    if mesh is None or batch % mesh.batch_size:
        return batch
    return batch // mesh.batch_size


def seq_parallel(shape: ShapeSpec, mesh, cfg: ModelConfig) -> bool:
    """A decode step at global batch 1 holds its caches' positions over
    ``data`` (the reference's ``seq_parallel``): the hybrid's shared K/V
    (a Mamba2 state has no positions; no other family decodes a global
    batch of 1 here)."""
    return (mesh is not None and shape.kind == "decode" and shape.global_batch == 1
            and mesh.data_size > 1 and cfg.family == "hybrid")


def rank_inputs(api, shape: ShapeSpec, mesh):
    """A prefill or decode cell's inputs as a rank of ``mesh`` holds them
    (meta tensors; the whole batch with no mesh): its rows
    (:func:`rank_rows`), the caches of its heads and channels (made
    inside the mesh), and at global batch 1 a decode's shared K/V cut
    to its positions over ``data`` (``hybrid.py::seq_shard_caches``).  The
    encdec's ``frames`` and ``enc_out`` and the vlm's ``embeds_prefix``
    are the rank's rows; an encdec decode at a global batch of 1 over
    more than one data rank, whose ``enc_out`` the reference cuts by
    position, raises (not ported)."""
    from repro_torch.models.hybrid import seq_shard_caches

    if (mesh is not None and shape.kind == "decode" and shape.global_batch == 1
            and mesh.data_size > 1 and api.cfg.family == "encdec"):
        raise NotImplementedError(
            "an encdec decode at a global batch of 1 cuts enc_out's positions over data in "
            "the reference; the port does not (no applicable cell decodes one: long_500k "
            "does not apply to a quadratic config)")
    rows, s = rank_rows(shape.global_batch, mesh), shape.seq_len
    with use_mesh(mesh):
        if shape.kind == "prefill":
            return api.prefill_inputs(rows, s)
        inputs = api.decode_inputs(rows, s)
    if seq_parallel(shape, mesh, api.cfg):
        inputs = dict(inputs, caches=seq_shard_caches(inputs["caches"], mesh),
                      seq_parallel=True)
    return inputs


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


def stack_depths(cfg: ModelConfig) -> dict:
    """path -> the depth of its layer stack, for every stacked parameter of
    ``cfg``'s model (``layers/``; the encdec's ``enc_layers/`` and
    ``dec_layers/`` each its own)."""
    from repro_torch.core.prequant import layer_index, param_path

    out = {}
    for name, _, _ in meta_params(cfg):
        if layer_index(name) is not None:
            out[param_path(name)] = out.get(param_path(name), 0) + 1
    return out


def param_bytes_rules(cfg: ModelConfig, mesh) -> float:
    """A device's parameter bytes by the reference's rules
    (``spec_for_param`` and ``sanitize`` on the stacked leaves, the port's
    copies): the count a rank holds, but for whole kv heads where kv <
    tp (``kv_heads_for_rank``)."""
    from repro_torch.core.prequant import param_path

    tp = mesh.model_size
    depth = stack_depths(cfg)
    seen, total = set(), 0.0
    for name, shape, dtype in meta_params(cfg):
        path = param_path(name)
        if path in seen:
            continue
        seen.add(path)
        stacked = ((depth[path],) if path in depth else ()) + shape
        dims = sanitize(mesh, spec_for_param(path, len(stacked)), stacked)
        n = 1
        for size, d in zip(stacked, dims):
            n *= size // (tp if d == "model" else 1)
        total += n * dtype.itemsize
    return total


def state_bytes_rules(cfg: ModelConfig, mesh) -> float:
    """A device's AdamW m + v bytes under the reference's ZeRO-1
    (``_zero1_dims`` on the stacked leaves, f32 m and v)."""
    total, seen = 0.0, set()
    depth = stack_depths(cfg)
    for lay in leaf_layouts(cfg, mesh).values():
        if lay.path in seen:
            continue
        seen.add(lay.path)
        shape = ((depth[lay.path],) if lay.layer is not None else ()) + lay.shape
        total += 8 * zero1_numel(shape, zero1_dims(lay.path, shape, mesh), mesh)
    return total


def rank_param_bytes(cfg: ModelConfig, layouts, model_rank: int) -> float:
    """The parameter bytes model rank ``model_rank`` holds (its slices by
    each :class:`~repro_torch.parallel.sharding.LeafLayout` of ``layouts``)."""
    dtypes = {n: dtype.itemsize for n, _, dtype in meta_params(cfg)}
    total = 0.0
    for name, lay in layouts.items():
        n = 1
        for i, size in enumerate(lay.shape):
            n *= len(lay.keep(model_rank)) if i == lay.dim else size
        total += n * dtypes[name]
    return total


def collectives_by_axis(ana, mesh) -> dict:
    """The analysis' collectives, each axis with its group's size, the link
    its groups cross (``roofline.py::axis_link``) and its bytes and calls
    by kind."""
    out = ana.as_dict()
    for axis, row in out["by_axis"].items():
        row["link"] = axis_link(mesh.shape, axis)
    return out


def analyze_cell(cfg: ModelConfig, shape: ShapeSpec, *, prequantize=False, tag="",
                 warmup=False, mesh=None, inputs=None):
    """The dry-run record of one cell, and its analysis.  ``warmup`` runs
    the step once untraced first, as a process that has run it before
    would (its K3 tables built: the card's step after a warm-up).  Under
    a ``mesh``, rank ``mesh.rank``'s step (the step runs in the mesh, whose
    collectives the analysis counts).  ``inputs``: as :func:`build_cell`'s."""
    t0 = time.time()
    step, args = build_cell(cfg, shape, prequantize=prequantize, mesh=mesh, inputs=inputs)
    with use_mesh(mesh):
        if warmup:
            step(*args)
        if mesh is not None:  # the traced step's collectives alone
            mesh.traffic.clear()
        ana, launches, out = trace_step(step, args)
    trace_s = time.time() - t0
    opt = args[1] if shape.kind == "train" else {}
    inputs = args[-1]
    if shape.kind == "train" and mesh is not None:
        inputs = local_rows(inputs, mesh)
    parts = {"param_bytes": float(sum(_storages(args[0]).values())),
             "opt_state_bytes": float(sum(_storages({k: v for k, v in opt.items()
                                                     if k != "step"}).values())),
             "input_bytes": float(sum(_storages(inputs).values()))}
    arg_bytes = parts["param_bytes"] + float(sum(_storages(opt).values())) + parts["input_bytes"]
    dev_bytes, dev_src = device_bytes()
    peak = arg_bytes + ana.peak_live_bytes
    del out
    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "mesh": "1" if mesh is None else mesh_name(mesh),
        "devices": 1 if mesh is None else mesh.world_size,
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
    }
    if mesh is not None:
        rec["collectives"] = collectives_by_axis(ana, mesh)
        rec["rank"] = {"rank": mesh.rank, "data": mesh.data_rank, "model": mesh.model_rank,
                       "batch_rows": rank_rows(shape.global_batch, mesh),
                       "seq_parallel": seq_parallel(shape, mesh, cfg)}
        rec["memory"].update(parts, param_bytes_rules=param_bytes_rules(cfg, mesh))
        if shape.kind == "train":
            rec["memory"]["opt_state_bytes_rules"] = state_bytes_rules(cfg, mesh)
    return rec, ana


def analyze_mesh_cell(cfg: ModelConfig, shape: ShapeSpec, mesh_spec: str, *, prequantize=False,
                      tag=""):
    """The record of one cell on the virtual mesh ``mesh_spec``: rank 0's,
    and where another model rank holds more parameter bytes (kv heads that
    the ranks keep unevenly), that rank's as well, in ``ranks``.  Returns
    (record, rank 0's analysis)."""
    mesh = make_virtual_mesh(mesh_spec, 0)
    check_shardable(cfg, mesh.model_size)
    rec, ana = analyze_cell(cfg, shape, prequantize=prequantize, tag=tag, mesh=mesh)
    layouts = leaf_layouts(cfg, mesh)
    by_rank = [rank_param_bytes(cfg, layouts, r) for r in range(mesh.model_size)]
    rec["ranks"] = {"param_bytes_by_model_rank_max": max(by_rank),
                    "param_bytes_by_model_rank_min": min(by_rank), "analysed": [0]}
    largest = max(range(len(by_rank)), key=lambda r: (by_rank[r], -r))
    if by_rank[largest] > by_rank[0]:
        other, _ = analyze_cell(cfg, shape, prequantize=prequantize, tag=tag,
                                mesh=make_virtual_mesh(mesh_spec, largest))
        rec["ranks"]["analysed"].append(largest)
        rec["ranks"][str(largest)] = {k: other[k] for k in (
            "flops", "bytes_accessed", "collectives", "memory", "launches")}
    return rec, ana


def run_cell(arch: str, shape_name: str, *, out_dir="build/dryrun", cfg_override=None,
             tag="", prequantize=False, mesh_spec=None):
    cfg = cfg_override or get_config(arch)
    shape = shape_by_name(shape_name)
    mesh_tag = mesh_spec or "1"
    if mesh_spec is not None:
        mesh_tag = mesh_name(make_virtual_mesh(mesh_spec))
    stem = f"{arch}__{shape_name}__{mesh_tag}{('__' + tag) if tag else ''}"
    os.makedirs(out_dir, exist_ok=True)
    ana = None
    if shape not in applicable_shapes(cfg):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "skipped": SKIPPED}
    elif mesh_spec is None:
        rec, ana = analyze_cell(cfg, shape, prequantize=prequantize, tag=tag)
    else:
        rec, ana = analyze_mesh_cell(cfg, shape, mesh_spec, prequantize=prequantize, tag=tag)
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
                    help="one rank of the reference's 2 x 16 x 16 mesh (512 cards)")
    ap.add_argument("--mesh", default=None,
                    help="one rank of a virtual DxM or PxDxM mesh (16x16: the reference's "
                         "production mesh)")
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
    mesh_spec = args.mesh
    if args.multi_pod:
        if mesh_spec not in (None, "2x16x16"):
            ap.error("--multi-pod is the 2x16x16 mesh; give it or --mesh, not both")
        mesh_spec = mesh_name(make_production_mesh(multi_pod=True))

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
                           prequantize=args.prequantized, mesh_spec=mesh_spec)
            if "skipped" in rec:
                print(f"[SKIP] {arch} x {shape} ({rec['mesh']}): {rec['skipped']}", flush=True)
                continue
            mem = rec["memory"]
            print(f"[OK] {arch} x {shape} ({rec['mesh']}): flops={rec['flops']:.3e} "
                  f"int_ops={rec['int_ops']:.3e} bytes={rec['bytes_accessed']:.3e} "
                  f"coll={rec['collectives']['collective_total']:.3e} "
                  f"peak={mem['peak_bytes'] / 1e9:.2f}GB fits={mem['fits']} "
                  f"launches={rec['launches']} trace={rec['trace_s']}s", flush=True)
        except Exception as e:  # noqa: BLE001 - a failing cell is a bug to surface
            print(f"[FAIL] {arch} x {shape}: {type(e).__name__}: {e}", flush=True)
            raise
    print(f"{len(cells)} cells in {time.time() - t_all:.1f} s", flush=True)


if __name__ == "__main__":
    main()
