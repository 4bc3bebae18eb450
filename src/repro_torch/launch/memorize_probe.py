"""What AdamW steps do to the one batch they are taken on.

A dense or vlm model's training cell (``launch/dryrun.py::build_cell``:
seeded weights and inputs, random labels, AdamW at lr 1e-4 under the
config's numerics) is stepped ``--steps`` times on one batch, as
``chip_smoke.py``'s phase ``tp_encdec`` steps qwen2-vl-72b.  Before the
first step and after each, the same batch's forward is read position by
position: the loss, the share of labelled positions whose gold token is
the argmax, the median gap between the two largest logits, the largest
logit.  A loss that reads 0 in f32 while the gold token is every
position's argmax by a gap of tens of logits is the batch memorized
(lse - gold below f32's rounding), not a fault of the loss.

Run on a card:
``python -m repro_torch.launch.memorize_probe --arch qwen2-vl-72b --layers 2``
(``--device cpu --reduced`` for a reduced config on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List

import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.models import transformer as tf
from repro_torch.models.registry import vlm_patches


def read(cfg, model, batch) -> Dict[str, float]:
    """The batch's loss and its logits read at each labelled position."""
    with torch.no_grad():
        labels = torch.as_tensor(batch["labels"]).to(torch.long)
        x = tf.embed_tokens(cfg, model, batch["tokens"])
        if "embeds_prefix" in batch:
            x = torch.cat([batch["embeds_prefix"].to(x.dtype), x], dim=1)
        pos = tf.default_positions(cfg, x.shape[0], x.shape[1], device=x.device)
        hidden, _ = tf.lm_backbone(cfg, model, x, pos)
        logits = tf.lm_logits(cfg, model, hidden[:, -labels.shape[1]:]).float()
        keep = labels >= 0
        gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0][keep]
        top = logits.topk(2, dim=-1)
        return {"loss": float(tf.train_loss(cfg, model, batch)),
                "gold_is_argmax": float((top.indices[..., 0][keep] == labels[keep]).float().mean()),
                "top2_gap_median": float((top.values[..., 0] - top.values[..., 1])[keep].median()),
                "max_logit": float(logits.max()),
                "lse_minus_gold_max": float((torch.logsumexp(logits, -1)[keep] - gold).max())}


def probe(arch: str, layers: int, steps: int, tokens: int, rows: int, device: str,
          reduced: bool = False) -> List[Dict[str, float]]:
    """``read`` before the first of ``steps`` steps and after each."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"{arch}: the probe reads a dense or vlm LM, not {cfg.family}")
    cfg = dataclasses.replace(cfg, n_layers=layers)
    seq = tokens + (vlm_patches(cfg) if cfg.family == "vlm" else 0)
    step, (model, opt, batch) = dryrun.build_cell(cfg, ShapeSpec("probe", seq, rows, "train"),
                                                  device=torch.device(device))
    out = [read(cfg, model, batch)]
    for _ in range(steps):
        step(model, opt, batch)
        out.append(read(cfg, model, batch))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-vl-72b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=128, help="labelled tokens a row")
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    got = probe(args.arch, args.layers, args.steps, args.tokens, args.rows, args.device,
                args.reduced)
    for i, r in enumerate(got):
        print(json.dumps({"after_steps": i, **r}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
