"""Where one card's bf16 tokens of a state-space model come to depend on
the batch, and how far a (data x model) mesh moves them beyond that.

mamba2-780m at full width and depth under ``default=plam_sim:16:1`` with
int16 prequantized seeded weights is served greedily, as
``chip_smoke.py``'s phase ``tp_ssm`` serves it:

1. **op by op.**  The prefill of two prompts runs at batch 2, then at
   batch 4 whose first two rows are the same prompts; a decode step runs
   at batch 2 and at batch 4 over the batch-2 caches twice over.  Every
   aten op (and each K1 call, ``ops.plam_matmul_float``) is recorded by a
   dispatch mode: an op whose inputs' first two rows agree between the
   runs and whose output's do not is one whose result depends on the
   batch.  Each such op is listed by name, dtype and shapes.
2. **over prompt seeds** (``SEEDS``).  Where the tokens of batch 2 part
   from those of batch 4 (each row's first differing position, batch 4's
   top-2 margin there, and the largest top-logit difference before it);
   then a world of ``data x model`` ranks (``launch/mesh.py::spawn``;
   gloo where the ranks share a card) against one rank at the same batch
   of 2 rows.

Run on a card:
``python -m repro_torch.launch.batch_noise [--out PATH]``;
the record goes to ``--out`` (``build/batch_noise.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

ROWS, SEQ, DECODE = 4, 64, 8  # phase tp_ssm's prompt and greedy steps
MESH = (2, 2)  # (data, model)
ARCH = "mamba2-780m"
SEEDS = (77, 1, 2, 3)  # prompt seeds, drawn over the model's vocabulary
#: ops that allocate without writing: their outputs are not compared
_ALLOC = ("aten.empty", "aten.new_empty", "aten.empty_like", "aten.empty_strided")


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def rows_of(big: torch.Tensor, small: torch.Tensor) -> List[torch.Tensor]:
    """The parts of ``big`` (a tensor of the batch-4 run) that may be
    ``small`` (its batch-2 counterpart): the whole where the shapes agree;
    where one dimension is twice as long, that dimension read as (P, 4,
    Q), the batch folded between other dimensions, for every such P,
    narrowed to its first 2 rows; none where no dimension is."""
    if big.shape == small.shape:
        return [big]
    if big.dim() != small.dim():
        return []
    dims = [d for d in range(big.dim()) if big.shape[d] != small.shape[d]]
    if len(dims) != 1 or big.shape[dims[0]] != 2 * small.shape[dims[0]]:
        return []
    d, n = dims[0], big.shape[dims[0]]
    out = []
    for p in range(1, n // 4 + 1):
        if (n // 4) % p:
            continue
        q = n // (4 * p)
        split = big.unflatten(d, (p, 4, q)).narrow(d + 1, 0, 2)
        out.append(split.flatten(d, d + 2))
    return out


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return bool(torch.equal(a, b))


def _agree(big: torch.Tensor, small: torch.Tensor) -> bool:
    return any(_equal(part, small) for part in rows_of(big, small))


def _diff(big: torch.Tensor, small: torch.Tensor) -> float:
    parts = [p for p in rows_of(big, small) if p.is_floating_point()]
    if not parts:
        return float("nan")
    return min(float((p.float() - small.float()).abs().nan_to_num(0.0).max()) for p in parts)


def _describe(name: str, tensors: List[torch.Tensor]) -> str:
    return f"{name}(" + ", ".join(f"{str(t.dtype)[6:]}{list(t.shape)}" for t in tensors) + ")"


class OpProbe(TorchDispatchMode):
    """Records every aten op of a block: in ``mode="store"`` clones of its
    inputs and outputs; in ``mode="compare"`` each op against the stored
    one of the same index (the same code path at another batch), keeping
    the ops whose outputs differ and, of those, the ones whose inputs
    agreed (``origins``)."""

    def __init__(self, store=None):
        super().__init__()
        self.store = store
        self.ops: List = []
        self.differ: List[dict] = []
        self.origins: List[dict] = []

    def note(self, name: str, ins: List[torch.Tensor], fn):
        if self.store is None:
            saved = [t.detach().clone() for t in ins]
            out = fn()
            self.ops.append((name, saved, [t.detach().clone() for t in _tensors(out)]))
            return out
        i = len(self.ops)
        self.ops.append(name)
        if i >= len(self.store) or self.store[i][0] != name:
            raise RuntimeError(f"op {i}: {name} where the stored run had "
                               f"{self.store[i][0] if i < len(self.store) else 'none'}")
        _, s_in, s_out = self.store[i]
        agree_in = all(_agree(a, b) for a, b in zip(ins, s_in))
        out = fn()
        if not name.startswith(_ALLOC):
            outs = _tensors(out)
            if not all(_agree(a, b) for a, b in zip(outs, s_out)):
                row = {"op": i, "what": _describe(name, ins),
                       "out": [list(t.shape) for t in outs], "inputs_agree": agree_in,
                       "max_abs_diff": max(_diff(a, b) for a, b in zip(outs, s_out))}
                self.differ.append(row)
                if agree_in:
                    self.origins.append(row)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors(args) + [v for k, v in kwargs.items()
                                if k != "out" and isinstance(v, torch.Tensor)]
        return self.note(str(func), ins, lambda: func(*args, **kwargs))


def probed(fn, store=None):
    """``fn()`` under an :class:`OpProbe` that also sees each K1 call."""
    from repro_torch.kernels import ops

    real = ops.plam_matmul_float
    probe = OpProbe(store)

    def k1(x, b, spec, **kw):  # one op: its own aten calls and the probe's are not recorded
        with _disable_current_modes():
            return probe.note("K1 plam_matmul_float", [x, b], lambda: real(x, b, spec, **kw))

    ops.plam_matmul_float = k1
    try:
        with probe:
            out = fn()
    finally:
        ops.plam_matmul_float = real
    return out, probe


def model_for(cfg, device, mesh=None):
    from repro_torch.core.prequant import quantize_params
    from repro_torch.models import build

    model = build(cfg).init(seed=0, device=device, mesh=mesh)
    quantize_params(cfg, model)
    return model


def generate(cfg, model, prompt, mesh=None) -> Dict[str, torch.Tensor]:
    """Greedy tokens, top logits and top-2 margins [rows, 1 + DECODE] of
    ``prompt``'s prefill and DECODE decode steps (the registry's forms)."""
    from repro_torch.models import build
    from repro_torch.parallel.sharding import use_mesh

    api = build(cfg)
    out = {"tokens": [], "top": [], "margins": []}

    def keep(logits):
        top = logits[:, -1].float().topk(2, dim=-1)
        out["tokens"].append(top.indices[:, 0])
        out["top"].append(top.values[:, 0])
        out["margins"].append(top.values[:, 0] - top.values[:, 1])
        return top.indices[:, :1].to(torch.int32)

    with torch.no_grad(), use_mesh(mesh):
        logits, caches = api.prefill(model, {"tokens": prompt})
        tok = keep(logits)
        for i in range(DECODE):
            logits, caches = api.decode_step(
                model, {"token": tok, "caches": caches, "cache_len": prompt.shape[1] + i})
            tok = keep(logits)
    return {k: torch.stack(v, dim=1).cpu() for k, v in out.items()}


def departures(got, want) -> dict:
    """Where ``got``'s tokens first part from ``want``'s in each row:
    (row, position, ``want``'s top-2 margin there), and the largest
    |difference| of the top logit before that."""
    parts, gap = [], 0.0
    for r in range(want["tokens"].shape[0]):
        differ = (got["tokens"][r] != want["tokens"][r]).nonzero()
        j = int(differ[0, 0]) if len(differ) else want["tokens"].shape[1]
        if j < want["tokens"].shape[1]:
            parts.append((r, j, float(want["margins"][r, j])))
        if j:
            gap = max(gap, float((got["top"][r, :j] - want["top"][r, :j]).abs().max()))
    return {"parts": parts, "top_logit_gap": gap}


def prompts(cfg, seeds, device) -> Dict[int, torch.Tensor]:
    out = {}
    for s in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(s)
        out[s] = torch.randint(0, cfg.vocab, (ROWS, SEQ), generator=g, device=device)
    return out


def probe_ops(cfg, model, prompt) -> dict:
    """Part 1: the ops whose result depends on the batch, in the prefill
    and in a decode step."""
    from repro_torch.models import build

    api = build(cfg)
    res = {}
    with torch.no_grad():
        two = prompt[:2].contiguous()
        (_, caches2), run2 = probed(lambda: api.prefill(model, {"tokens": two}))
        _, run4 = probed(lambda: api.prefill(model, {"tokens": prompt}), run2.ops)
        res["prefill"] = {"ops": len(run4.ops), "differ": len(run4.differ),
                          "first_differ": run4.differ[:5], "origins": run4.origins[:40]}
        del run2, run4
        tok = prompt[:2, -1:].to(torch.int32)
        caches4 = {k: torch.cat([v, v], dim=1) for k, v in caches2.items()}
        batch2 = {"token": tok, "caches": {k: v.clone() for k, v in caches2.items()},
                  "cache_len": prompt.shape[1]}
        batch4 = {"token": torch.cat([tok, tok]), "caches": caches4,
                  "cache_len": prompt.shape[1]}
        _, run2 = probed(lambda: api.decode_step(model, batch2))
        _, run4 = probed(lambda: api.decode_step(model, batch4), run2.ops)
        res["decode"] = {"ops": len(run4.ops), "differ": len(run4.differ),
                         "first_differ": run4.differ[:5], "origins": run4.origins[:40]}
    kinds: Dict[str, int] = {}
    for form in ("prefill", "decode"):
        for row in res[form]["origins"]:
            kinds[row["what"]] = kinds.get(row["what"], 0) + 1
    res["origin_ops"] = kinds
    return res


def world_rank(device, cfg, chunks):
    """One rank of part 2's world: its data rank's rows of each prompt."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data=MESH[0], model=MESH[1])
    model = model_for(cfg, device, mesh)
    out = {}
    for seed, prompt in chunks.items():
        mine = prompt.chunk(MESH[0])[mesh.data_rank].to(device)
        run = generate(cfg, model, mine, mesh)
        out[seed] = {k: torch.cat(mesh.all_gather(v.to(device).contiguous(), "data")).cpu()
                     for k, v in run.items()}
    return out if mesh.rank == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "batch_noise.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("batch_noise: needs a CUDA card", flush=True)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.batch_noise import world_rank as rank_fn  # pickled by its module
    from repro_torch.launch.mesh import spawn

    _lib.build()
    dev = torch.device("cuda")
    cfg = get_config(ARCH).with_numerics("default=plam_sim:16:1")
    seeds = list(SEEDS)
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "rows": ROWS, "seq": SEQ,
           "decode": DECODE, "mesh": {"data": MESH[0], "model": MESH[1]},
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32},
           "card": torch.cuda.get_device_name(0)}
    t0 = time.perf_counter()
    model = model_for(cfg, dev)
    ps = prompts(cfg, seeds, dev)
    rec["ops"] = probe_ops(cfg, model, ps[seeds[0]])
    print(f"batch_noise {cfg.name}: prefill {rec['ops']['prefill']['ops']} ops, "
          f"{rec['ops']['prefill']['differ']} differ between batch 2 and 4; decode "
          f"{rec['ops']['decode']['ops']} ops, {rec['ops']['decode']['differ']} differ; "
          f"ops that part with agreeing inputs: {rec['ops']['origin_ops']}", flush=True)
    for form in ("prefill", "decode"):
        for row in rec["ops"][form]["origins"][:6]:
            print(f"  {form} origin {row}", flush=True)
        for row in rec["ops"][form]["first_differ"][:3]:
            print(f"  {form} first differing {row}", flush=True)
    one2, one4 = {}, {}
    rec["seeds"] = {}
    for s, prompt in ps.items():
        one4[s] = generate(cfg, model, prompt)
        halves = [generate(cfg, model, p) for p in prompt.chunk(MESH[0])]
        one2[s] = {k: torch.cat([h[k] for h in halves]) for k in halves[0]}
        rec["seeds"][s] = {"batch2_vs_batch4": departures(one2[s], one4[s])}
        print(f"  seed {s}: one card, batch 2 against batch 4: "
              f"{rec['seeds'][s]['batch2_vs_batch4']}", flush=True)
    del model
    torch.cuda.empty_cache()
    rec["one_card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    world = spawn(rank_fn, MESH[0] * MESH[1], "cuda", cfg,
                  {s: p.cpu() for s, p in ps.items()})[0]
    rec["world_s"] = time.perf_counter() - t0
    for s in ps:
        rec["seeds"][s]["world_vs_one_card_batch2"] = departures(world[s], one2[s])
        print(f"  seed {s}: the world against one card at batch 2: "
              f"{rec['seeds'][s]['world_vs_one_card_batch2']}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(f"batch_noise: wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
