"""Roofline analysis over dry-run records, for one H100 (port of
``repro/launch/roofline.py``).

Per (arch x shape) cell, from the op-level analysis that ``dryrun.py``
records (``launch/op_analysis.py``):

  compute term    = sum over classes of the class's operations / its peak:
                    matmul FLOPs by class (bf16/fp16 on the tensor cores,
                    TF32, f32 on the CUDA cores), the port's kernels'
                    integer lane operations, and the other ops' result
                    elements (the reference's VPU proxy)
  memory term     = bytes_accessed / HBM_BW
  collective term = each mesh axis' link bytes (the reference's ring
                    factors) over the link its group crosses: NVLink
                    (LINK_BW) inside one node of CARDS_PER_NODE cards,
                    the node's InfiniBand (IB_BW a card) where the
                    group spans nodes (:func:`axis_link`)

The hardware constants are an H100 SXM's (NVIDIA H100 Tensor Core GPU
data sheet, SXM5 column, dense rates), where the reference has a TPU
v5e's.  ``PEAK_INT32`` is the integer lane rate the port's kernel bounds
use (132 SMs x 64 INT32 lanes x the 1.98 GHz boost clock); ``PEAK_ELEM``
is a documented heuristic, as the reference's ``PEAK_VPU`` is: one
element a lane a clock over the 128 FP32 lanes of each SM.

``model_flops`` and ``model_bytes`` are the reference's (6 N D train, 2
N D prefill, 2 N_active B decode, plus the attention terms; weights read
once and the cache or one activation pass), copied here.

``t_ideal`` is the useful work over the peak of the step's numerics:
under ``plam_sim`` a product is one integer add on the CUDA cores (K1),
so ``model_flops / 2`` products at ``PEAK_INT32``; an f32 carrier
(``f32``, ``posit_quant``, ``mitchell_f32``) multiplies on the CUDA cores
at ``PEAK_F32``; ``bf16`` at ``PEAK_BF16`` -- or ``model_bytes`` over
``HBM_BW``, whichever is larger.  The reference charges every mode to the
MXU.  ``roofline_fraction`` = t_ideal / t_bound, as there.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --dir build/dryrun --mesh 1
"""
from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Dict

PEAK_BF16 = 989e12  # dense bf16/fp16 tensor-core FLOP/s
PEAK_TF32 = 495e12  # dense TF32 tensor-core FLOP/s
PEAK_F32 = 67e12  # f32 CUDA-core FLOP/s
SMS = 132  # streaming multiprocessors
INT32_LANES_PER_SM = 64  # INT32 lanes an SM issues a clock
BOOST_CLOCK_HZ = 1.98e9  # max SM clock
PEAK_INT32 = SMS * INT32_LANES_PER_SM * BOOST_CLOCK_HZ  # ~16.7e12 lane ops/s
PEAK_ELEM = SMS * 128 * BOOST_CLOCK_HZ  # heuristic: ~33.4e12 elements/s
HBM_BW = 3.35e12  # HBM3 bytes/s
HBM_BYTES = 80e9  # device memory
LINK_BW = 450e9  # NVLink 4 bytes/s per direction
# a DGX H100 node (NVIDIA DGX H100 data sheet): 8 cards joined by NVLink,
# and 8 single-port ConnectX-7 adapters of 400 Gb/s, one a card, to the
# InfiniBand fabric between nodes
CARDS_PER_NODE = 8
IB_BW = 400e9 / 8  # bytes/s per card per direction (ConnectX-7, 400 Gb/s)
LINKS = {"nvlink": LINK_BW, "ib": IB_BW}

#: the peak of each class of compute that op_analysis.py records
CLASS_PEAKS = {"bf16": PEAK_BF16, "tf32": PEAK_TF32, "f32": PEAK_F32}

# ring-algorithm byte multipliers on result bytes (the reference's)
_COLL_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def count_params(cfg) -> Dict[str, float]:
    """Total / active (MoE top-k utilized) / encoder / decoder params of
    the model ``init`` builds, counted on the meta device, classified as
    the reference does: every ``wg``/``wu``/``wd`` under a MoE layer counts
    as routed (its shared experts' too, scaled by top_k / E with the
    rest), and ``enc_layers`` and the frontend are the encoder."""
    from repro_torch.models.registry import build

    model = build(cfg).init(0, device="meta")
    total = routed = enc = 0
    for name, p in model.named_parameters():
        parts = name.split(".")
        total += p.numel()
        if "moe" in parts and parts[-1] in ("wg", "wu", "wd"):
            routed += p.numel()
        if parts[0] == "enc_layers" or parts[0].startswith("frontend"):
            enc += p.numel()
    active = total - routed
    if cfg.n_experts:
        active += routed * cfg.top_k / cfg.n_experts
    return {"total": float(total), "active": float(active),
            "enc": float(enc), "dec": float(total - enc)}


def model_flops(cfg, shape, params: Dict[str, float]) -> float:
    """Ideal useful FLOPs for the step (global, all chips)."""
    n_act = params["active"]
    b, s = shape.global_batch, shape.seq_len
    d_attn = (cfg.n_heads or 0) * cfg.hd if cfg.n_heads else 0

    def dense_flops(mult):
        if cfg.family == "encdec":
            # encoder sees s source frames, decoder sees <=4096 targets
            tgt = min(s, 4096)
            return mult * (params["enc"] * b * s + params["dec"] * b * tgt)
        return mult * n_act * b * s

    if shape.kind == "train":
        flops = dense_flops(6.0)
        # causal attention quadratic term: fwd 2*2*(S^2/2)*d_attn per layer
        if d_attn and cfg.family != "encdec":
            flops += 3 * 2 * 2 * 0.5 * cfg.n_layers * s * s * d_attn * b
        return flops
    if shape.kind == "prefill":
        flops = dense_flops(2.0)
        if d_attn and cfg.family != "encdec":
            flops += 2 * 2 * 0.5 * cfg.n_layers * s * s * d_attn * b
        return flops
    # decode: one token over a cache of length s
    flops = 2.0 * n_act * b
    if d_attn and cfg.family not in ("ssm",):
        layers = cfg.n_layers if cfg.family != "hybrid" else cfg.n_layers // max(cfg.shared_attn_every, 1)
        kv_d = (cfg.n_kv or 0) * cfg.hd
        flops += 2 * 2 * layers * s * (kv_d or d_attn) * b
    return flops


def model_bytes(cfg, shape, params) -> float:
    """Ideal HBM traffic for the step (global): weights read once +
    KV/state cache read+written once (decode) or activations (train)."""
    wb = params["active"] * 2  # bf16 weights
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        if cfg.family == "ssm":
            cache = cfg.n_layers * b * (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim) \
                * cfg.ssm_state * cfg.ssm_head_dim * 4
        elif cfg.family == "hybrid":
            n_inv = cfg.n_layers // max(cfg.shared_attn_every, 1)
            cache = n_inv * b * s * cfg.n_kv * (2 * cfg.d_model // cfg.n_heads) * 2 * 2
            cache += cfg.n_layers * b * 2 * cfg.d_model * cfg.ssm_state * 4
        else:
            layers = cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers
            slen = min(s, 4096) if cfg.family == "encdec" else s
            cache = layers * b * slen * cfg.n_kv * cfg.hd * 2 * 2
        return wb + cache
    # train/prefill: weights + one activations pass (rough ideal)
    act = cfg.n_layers * b * min(s, 524_288) * cfg.d_model * 2
    return wb + act


def step_mode(cfg) -> str:
    """The numerics mode of the step's matmuls: the policy's default."""
    from repro_torch.core.policy import as_policy

    return as_policy(cfg.numerics).resolve("default").mode


def ideal_seconds(mode: str, mflops: float, mbytes: float) -> float:
    """The ideal step: the useful work at the peak of ``mode``'s numerics,
    or the ideal bytes at HBM_BW, whichever takes longer."""
    if mode == "plam_sim":
        compute = mflops / 2 / PEAK_INT32  # one integer add a product (K1)
    elif mode == "bf16":
        compute = mflops / PEAK_BF16
    else:  # an f32 carrier: f32, posit_quant, mitchell_f32
        compute = mflops / PEAK_F32
    return max(compute, mbytes / HBM_BW)


def axis_link(shape: Dict[str, int], axis: str) -> str:
    """The link that ``axis``' collectives cross on a mesh of ``shape``
    ({"pod": P, "data": D, "model": M}; rank ((p D) + d) M + m, cards
    numbered node by node): ``"nvlink"`` when every group of the axis lies
    inside one node of CARDS_PER_NODE cards, else ``"ib"``.  ``batch`` is
    the (pod, data) group."""
    import itertools

    dims = {"pod": shape.get("pod", 1), "data": shape["data"], "model": shape["model"]}
    varied = {"batch": ("pod", "data")}.get(axis, (axis,))
    fixed = [a for a in dims if a not in varied]

    def rank(idx):
        return (idx["pod"] * dims["data"] + idx["data"]) * dims["model"] + idx["model"]

    for held in itertools.product(*(range(dims[a]) for a in fixed)):
        base = dict(zip(fixed, held))
        nodes = {rank({**base, **dict(zip(varied, v))}) // CARDS_PER_NODE
                 for v in itertools.product(*(range(dims[a]) for a in varied))}
        if len(nodes) > 1:
            return "ib"
    return "nvlink"


def terms(rec: dict) -> Dict[str, float]:
    """The compute, memory and collective terms of a dry-run record (the
    collectives priced axis by axis at their link, ``by_axis``'s
    ``link``; a record without it at NVLink's)."""
    t_compute = sum(rec["flops_by_class"].get(c, 0.0) / peak for c, peak in CLASS_PEAKS.items())
    t_compute += rec.get("int_ops", 0.0) / PEAK_INT32 + rec.get("elem_ops", 0.0) / PEAK_ELEM
    coll = rec["collectives"]
    axes = coll.get("by_axis") or {"": {"bytes": coll["collective_bytes"], "link": "nvlink"}}
    t_coll = sum(sum(_COLL_FACTOR.get(k, 1.0) * v for k, v in ax["bytes"].items())
                 / LINKS[ax.get("link", "nvlink")] for ax in axes.values())
    return {"compute": t_compute, "memory": rec["bytes_accessed"] / HBM_BW,
            "collective": t_coll}


def roofline_row(rec: dict, cfg, shape) -> dict:
    ndev = rec["devices"]
    t = terms(rec)
    dominant = max(t, key=t.get)
    params = count_params(cfg)
    mf = model_flops(cfg, shape, params)
    mf_dev = mf / ndev
    mb_dev = model_bytes(cfg, shape, params) / ndev
    mode = step_mode(cfg)
    t_ideal = ideal_seconds(mode, mf_dev, mb_dev)
    t_bound = max(t.values())
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "numerics": rec.get("numerics", "?"),
        "mode": mode,
        "t_compute_s": t["compute"],
        "t_memory_s": t["memory"],
        "t_collective_s": t["collective"],
        "dominant": dominant,
        "t_bound_s": t_bound,
        "t_ideal_s": t_ideal,
        "model_flops_global": mf,
        "op_flops_per_dev": rec["flops"],
        "useful_ratio": mf_dev / rec["flops"] if rec["flops"] else float("nan"),
        "mem_useful_ratio": mb_dev / rec["bytes_accessed"] if rec["bytes_accessed"] else float("nan"),
        "roofline_fraction": t_ideal / t_bound if t_bound else float("nan"),
        "bytes_per_dev": rec["bytes_accessed"],
        "collectives_by_axis": rec["collectives"].get("by_axis", {}),
        "params_total": params["total"],
        "params_active": params["active"],
        "peak_gb": rec["memory"]["peak_bytes"] / 1e9,
        "fits": rec["memory"]["fits"],
        "tag": rec.get("tag", ""),
    }


def load_and_report(dryrun_dir="build/dryrun", out_md="build/roofline.md", mesh_filter="1"):
    from repro_torch.configs import get_config, shape_by_name

    rows = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if "skipped" in rec or rec.get("mesh") != mesh_filter or rec.get("tag"):
            continue
        cfg = get_config(rec["arch"])
        if rec.get("numerics_policy"):
            cfg = cfg.with_numerics(rec["numerics_policy"])
        rows.append(roofline_row(rec, cfg, shape_by_name(rec["shape"])))

    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    mesh = mesh_filter != "1"  # a rank's counts: its FLOPs, bytes and collectives by axis
    hdr = ("| arch | shape | dominant | compute s | memory s | collective s | "
           "useful-flops | useful-bytes | roofline frac | peak GB | fits |")
    if mesh:
        hdr += " flops/rank | bytes/rank | collective bytes/rank (axis, link) |"
    lines = [hdr, "|" + "---|" * (14 if mesh else 11)]
    for r in rows:
        line = (
            f"| {r['arch']} | {r['shape']} | **{r['dominant']}** | "
            f"{r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"{r['useful_ratio']:.2f} | {r['mem_useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {r['peak_gb']:.1f} | {r['fits']} |")
        if mesh:
            axes = "; ".join(f"{a} ({v['link']}) {sum(v['bytes'].values()):.3e}"
                             for a, v in r["collectives_by_axis"].items())
            line += f" {r['op_flops_per_dev']:.3e} | {r['bytes_per_dev']:.3e} | {axes} |"
        lines.append(line)
    md = "\n".join(lines)
    os.makedirs(os.path.dirname(out_md) or ".", exist_ok=True)
    with open(out_md, "w") as f:
        f.write(md + "\n")
    return rows, md


def reanalyze(dryrun_dir="build/dryrun"):
    """Re-aggregate the archived op traces (``<stem>.ops.jsonl.gz``, written
    by dryrun.py beside each record) and refresh the records' totals in
    place, without tracing the step again."""
    from repro_torch.launch.op_analysis import Analysis

    for f in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if "skipped" in rec:
            continue
        stem = os.path.splitext(f)[0]
        trace = stem + ".ops.jsonl.gz"
        if not os.path.exists(trace):
            continue
        with gzip.open(trace, "rt") as fh:
            ana = Analysis.from_trace(json.loads(line) for line in fh)
        rec.update(ana.record_fields())
        with open(f, "w") as fh:
            json.dump(rec, fh, indent=2)
        print(f"reanalyzed {os.path.basename(stem)}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--mesh", default="1")
    ap.add_argument("--out", default="build/roofline.md")
    ap.add_argument("--reanalyze", action="store_true")
    args = ap.parse_args()
    if args.reanalyze:
        reanalyze(args.dir)
    rows, md = load_and_report(args.dir, args.out, mesh_filter=args.mesh)
    print(md)
