#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check its kernels.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--layers N]
                          [--phases device,kernels,conformance,serve,serve_paths,observe,moe,
                                    static,archs,train,train_families,e2e,times,dryrun,tp,
                                    tp_train,tp_ssm,tp_encdec]

It imports ``repro_torch`` (never JAX) and runs eighteen phases, each on
its own lines:

1. device      — the card's name and power limit (nvidia-smi), the torch
   device, and the kernels' build from ``src/repro_torch/kernels/csrc``.
2. kernels     — each CUDA kernel against its plain PyTorch version on
   the card at its paths' shapes: the posit codec (K3; its encode's and
   its quantize's bf16 tables at eight specs, and all 65,536 bf16
   patterns through the table and computed paths of both, at odd offsets
   and at the table threshold's edges; its decode over all 65,536
   patterns, int16 and int32, at four specs), the PLAM matmul
   (K1: yi-6b's shapes at M = 4 and 64, every decode-batch M at one of
   them, ragged shapes at its decode path's tile, stage, strip and branch
   edges, and its prefill path's edges with planted zero and NaR k-tiles
   over pattern, f32 and bf16 A; and K1 over float activations, which it encodes itself,
   over all 65,536 bf16 patterns and a seeded f32 sweep with its edges,
   at ragged M, K and N and at every projection shape at the serve
   path's M, the chunk width and the verify rows) and the element-wise
   posit multipliers (K4) bit for bit, the
   paged (K2) and contiguous (K5) decode attention within stated
   tolerances, at serving and long contexts and at the length edges of
   their shared core (0 included) in every dtype pair they take (and at
   the MoE models' head layouts), and
   over seeded random shapes with NaN in every element they must not
   read.  K1 over a stack of experts (one launch) is held bit for bit to
   its grouped plain version over deepseek-moe-16b's and
   granite-moe-1b-a400m's first 8 experts at every M an expert's buffer
   has on the serve path, to the 2-D kernel run expert by expert over
   all 64 and 32 experts, and at ragged stacks; the 2-D kernel also at
   granite's unembed.  K3's quantize at the training path's weight,
   expert-stack and activation shapes, bf16 and f32, bit for bit.  Then K5's public entry
   point runs once per yi-6b layer at yi-6b's widths (K5 has no serving
   path).
3. conformance — ``python -m repro_torch.conformance check`` and
   ``fuzz --seed 0 --count 2048`` in-process on the default device, so
   the ``cuda`` oracle runs K3 and K4 beside the golden, torch, table and
   plain-kernel oracles; no failure, no mismatch, and K3 and K4 launched.
4. serve       — full-width yi-6b under ``default=plam_sim:16:1`` with
   int16 prequantized weights serves 4 requests through ``build_engine``
   -> ``submit`` -> ``run``; the launch counts must match 7L+1 weight
   encodes (K3) at build, 7L+1 PLAM matmuls and no codec call per
   forward (the activations are encoded inside K1), and L attention
   calls per decode step.  Then an engine that keeps its bf16 weights
   (``prequantize=False``) serves the same requests: 7L+1 K3 and 7L+1
   K1 launches a forward, no second table build, and the same greedy
   tokens.
5. serve_paths — the multi-token paged path at full width and depth:
   a 2-layer model's chunked prefill against its whole-prompt prefill
   (logits and pool), then, on one prequantized yi-6b handed to every
   engine, the serve phase's requests with chunked prefill, with
   recompute preemption on a pool just large enough for the longest
   request, and with n-gram speculative decoding, and a shared-prefix
   request set with the prefix cache on and off.  Each run is held to
   its plain run's greedy tokens (or, where a token differs, to a top-2
   margin of the plain context below the logit tolerance) and to the
   launches of each forward: 7L+1 K1, L K2 on a one-token decode step
   and none on a chunk or verify forward, no K3.
6. observe     — serving observability at full width and depth, on the
   serve phase's requests and encoded weights: three runs with tracing
   off and three with it on, in turns (equal greedy tokens, the serve
   phase's launch counts, the trace's grammar, each request's breakdown
   summing to its submit -> terminal time within 1e-9 s; step p50, decode
   tok/s and the host time inside the trace recorder reported); one run
   with the profiler spans inside ``torch.profiler``, each kernel
   attributed to the span whose host interval holds its launch call (by
   correlation id in the exported trace), per span its count, host ms and
   device ms, and the host's share of the decode step with and without
   the profiler (every K1 and K2 launch of a decode step inside its
   ``serve.decode`` span); then ``python -m repro_torch.launch.serve`` at
   full width, writing a Chrome trace, JSON lines and Prometheus files
   that the port's checkers must accept (a plam_sim MAC counter above 0,
   the prefix-cache families, ``steps=`` equal to ``serve_steps_total``).
7. moe         — the MoE family at full width: deepseek-moe-16b (28
   layers, 64 experts top-6, 2 shared) serves the serve phase's requests
   with its bf16 weights encoded on every forward (10L+1 K3 and 10L+1 K1
   launches a forward, 3L of them over all 64 experts at once; L K2 a
   decode step), then with its weights encoded once in place
   (``quantize_params``: 10L+1 encodes, the router kept f32; no K3 a
   forward) and the same greedy tokens; tok/s, step latency, peak memory
   and a profile of two decode steps (K1, K2, and the dispatch glue
   around them); then granite-moe-1b-a400m (24 layers, 32 experts top-8)
   prequantized: 7L+1 K1 a forward.  ``--layers`` cuts both depths.
8. static      — the static engine and the state-space families:
   mamba2-780m (48 Mamba2 layers, d_model 1536) and zamba2-1.2b (38
   layers at d_model 2048 and one shared attention block at 4096,
   applied 6 times), each at its config's full width and depth under
   ``default=plam_sim:16:1`` from the port's seeded init, on the static
   ``Engine``: 4 prompts of 64 tokens and then 2 of 320 (three SSD
   chunks, the last padded with dt = 0), 16 new tokens, with int16
   prequantized weights and then with bf16 weights encoded by K3 on
   every forward (equal tokens, or a top-2 margin below 0.1 where one
   differs); mamba2 also under its config's own ``posit_quant:16:1``, on
   bf16 weights and then prequantized (each forward K3's decode of every
   int16 weight and its quantize of every activation, each (shape, dtype)
   bit for bit against the plain version at its first launch, a decode
   step's calls those of ``K3_STEP_CALLS``; the bf16-weight run's
   tokens).
   Gates: every forward's launches (2L + 1 K1 for mamba2, 2L + 8 L/6 + 1
   for zamba2; as many K3 without prequantized weights, none with; no K2
   or K5), no plain K1 or codec call on the card, finite logits, decode
   after a prefill of t tokens within 0.1 of the last logits of a prefill
   of t + 1, and K1 bit for bit against its plain version on the first
   launch's own operands at every shape the phase launched.  Printed:
   decode tok/s, step p50/p95, prefill seconds, peak memory, a profile
   of two decode steps (idle share, top device ops) and K1's times at the
   new shapes beside its bound.  Then yi-6b at full width cut to 4
   layers on the static engine against the continuous engine (the
   serve-paths margin rule), a 2-layer draft model of its widths drafting
   4 tokens for it (committed tokens against spec_k=0's by the same
   rule; acceptance reported), and ``python -m repro_torch.launch.serve``
   without ``--continuous`` on mamba2-780m.
9. archs       — the other five architectures under
   ``default=plam_sim:16:1`` from the port's seeded init, prequantized:
   gemma-7b (head_dim 256, tied and scaled embeddings) and minitron-8b
   (relu2, no gate) at full width and depth on the continuous engine (4
   requests of 48 seeded tokens, 16 new) and then on the static engine
   (the same prompts: equal tokens, or the serve-paths margin rule), gemma
   also with bf16 weights encoded every forward (equal tokens);
   command-r-plus-104b (96/8 heads) at full width cut to 8 of 64 layers
   on the continuous engine; seamless-m4t-medium (encdec, full depth) on
   the static engine with 4 x 256 seeded frames and a 16-token target
   prefix, prequantized and under its config's own posit_quant:16:1; and
   qwen2-vl-72b (M-RoPE, 1,024 seeded patch embeddings ahead of 32 tokens
   a row, 2 rows) at full width cut to 12 of 80 layers on the static
   engine.  Gates: every forward's launches by ``launch_counts`` (K1 a
   projection, K3 for a tied head's ``embed.T`` every forward, L K2 a
   decode step on the continuous engine), the weight encodes at build,
   no plain K1 or codec call on the card, K1 bit for bit against its
   plain version at every (M, K, N) launched (the first launch's rows
   0-63 and its last 64-row block; a B made in the forward over its first
   and last 512 columns), K2 within K5's gates on its first four-slot
   decode step's operands (head_dim 256, and 12 q heads a kv head), the
   first decode step of the static models within 0.1 of a prefill of one
   more token, and each of the five at 2 layers on the kernels within
   0.1 of the plain versions.  Printed: decode tok/s, step p50/p95,
   prefill seconds, peak memory, two profiled decode steps, K1's device
   time at each new (K, N) beside its bound, K2's beside its bound and
   SDPA's.
10. train      — training and the paper's Table II: full-width yi-6b
   (bf16, remat, ``posit_quant:16:1``) cut to 8 layers takes 6 AdamW
   steps through ``train.loop.make_train_step`` (losses finite and
   falling; every gradient finite and not all zero; per step K3's
   quantize launched 28L+4 times, the forward's 14L+2 and the remat
   recompute's as many; no plain codec call), reported as step seconds,
   tokens/s, the share of the f32 peak and peak memory; the trained
   weights served under ``default=plam_sim:16:1`` kept bf16 and then
   prequantized (7L+1 K1 a forward, L K2 a decode step, equal tokens),
   with ``calibrate`` on them in between; ``python -m
   repro_torch.launch.train``'s fault drill (restarts=1, final_step=8,
   the policy in the manifest; resumed losses within 1e-3 of an
   uninterrupted run's); the five Table II setups trained in f32 and
   evaluated under f32, posit16 (K3) and plam16 (K3 and K1), top-1 and
   top-5, beside the reference's own ``--quick`` rows.  K1 is held bit for
   bit to its plain version at every (A, B) shape and dtype that the
   Table II evaluations and ``calibrate``'s trials launched it with, on
   the operands and output of the first such launch.
11. train_families — the other families' training at full width, each
   under its config's own ``posit_quant:16:1`` with TF32 off: mamba2-780m
   and zamba2-1.2b (full depth), granite-moe-1b-a400m (full depth),
   deepseek-moe-16b cut to 4 of 28 layers (remat on, as its config) and
   qwen2-vl-72b cut to 2 of 80 (2 rows of 1,024 patch embeddings and 128
   tokens), seamless-m4t-medium (12 + 12 layers, 128 frames and 128
   target tokens); each takes 6 AdamW steps at lr 1e-3 through
   ``make_train_step`` on seeded ``train_inputs`` batches.  The SSD scan
   masks ``exp(dec)`` after forming it, as the reference does: at lr
   1e-3 the state-space models' masked exponent passes 88.7 (inf in f32)
   within two steps and the backward gives NaN (reported, with the step
   that overflowed), so they train again at 5e-5.  Gates: losses finite
   and falling; every float leaf's first moment finite and not all zero
   after step 0; K3's quantize launched a step as the hand count
   (``family_quantize_count``: both operands of every projection, the
   loss's head once a chunk and again in its checkpoint's recompute,
   every layer again under remat), confirmed by a no-grad forward; no
   plain K1 or codec call on the card; K3's quantize bit for bit against
   its plain version on the first launch's own operands at every (shape,
   dtype) the steps launched (the 3-D expert stacks and qwen2-vl's
   1.25 G-lane unembed among them).  Printed: step p50, tokens/s, the
   share of the f32 peak, peak memory, the SSD scan's largest masked
   exponent each step, batch 0's loss after the steps, a profiled step
   of mamba2 and deepseek.  Then the trained mamba2-780m (static engine)
   and 4-layer deepseek-moe-16b (continuous engine), encoded to int16 in
   place, serve 4 seeded requests under ``default=plam_sim:16:1`` on the
   kernels (K1, and K2 for deepseek) and on the plain versions: equal
   greedy tokens, or where the runs part a plain top-2 margin below 0.1
   (for deepseek, or a routing near-tie: a router top-k margin below
   ``MOE_ROUTE_TOL``); each family at 2 layers (the hybrid at 6) takes one
   batch's loss and gradients on the kernels and on the plain versions,
   equal bit for bit under deterministic algorithms; yi-6b at full width
   cut to 2 layers (f32) takes one batch of 2 x 1,024 with
   ``flash_block=128`` and without, within the CPU tests' f32
   tolerances, each with its peak memory.
12. e2e        — a 2-layer full-width model runs one prefill and 4
   decode steps on the kernels and on the plain versions; last logits
   must agree within a stated tolerance.  The same for a 2-layer
   deepseek-moe-16b over 2 decode steps, with the router's top-k margin
   logged wherever the two runs route a token differently; and
   ``mitchell_f32`` (plain torch) on the card against the CPU.
13. times      — CUDA-event times of each kernel, its plain version and
   (for attention) ``scaled_dot_product_attention``, beside each
   kernel's bound (and, for K1, the floor of its design, with the strip
   width of its prefill path).  Each
   kernel and library call is read two ways: the events' window as
   earlier runs read it (``ms``; for a short call it holds the host time
   of the wrapper), and after a device spin (``device_ms``: the card's
   time alone).  K1 over bf16 activations (one launch) is timed beside
   the codec-then-matmul pair it replaced, in turns, with each one's host
   time per call, and again on the activations one step of a seeded
   full-depth engine gives it.  K3's encode is timed at weight and
   activation shapes on both paths (``K3_TIMES``), beside a copy of the
   same bytes; its decode and quantize at 2^24 and 4,096 lanes and its
   quantize at the training paths' largest weights (the expert stacks
   and qwen2-vl's unembed among them) beside their bytes bound, the
   floor of their design, a copy of the same bytes and, in turns, their
   first form (``K3_VARIANTS``: variants of posit_codec.cu built beside it);
   its computed paths on both sides of one lane a thread
   (``K3_BY_LANE_SWEEP``), the quantize on both sides of its table
   threshold (``K3_TABLE_EDGE_SHAPES``), the K3 calls of a posit_quant
   decode step of mamba2-780m (``K3_STEP_CALLS``) and the table paths'
   fill and grid (``K3_FILL_SHAPES``).  K1 is also timed at
   the chunk width and the verify rows (M = 32, 20), and over a stack of
   deepseek's 64 experts at M = 1 and 7, beside its bytes bound and, in
   turns, the 64 launches of the 2-D kernel it replaces.  K2 is timed at
   the serving shape and at a long paged context, and K5 also at other
   split sizes.
14. dryrun     — the launch tools held against measured steps: for each
   of ``DRYRUN_CELLS`` (yi-6b's decode, mamba2-780m's prefill and
   granite-moe-1b-a400m's decode at full width under
   ``default=plam_sim:16:1`` with int16 prequantized weights, and yi-6b's
   training step at phase train's width, depth and numerics) the step of
   ``launch/dryrun.py::build_cell`` is built on the card from the port's
   seeded init, run once, then timed over ``DRYRUN_STEPS`` steps (host
   clock after a synchronize, p50) with the peak of allocated memory and
   the launches of each step, and then dry-run on the meta device.  Gates:
   the launches by kernel equal the dry run's; the dry run's peak bytes
   within ``DRYRUN_MEM_TOL`` of the measured peak; the roofline's bound
   time (``launch/roofline.py``) at most ``DRYRUN_BOUND_SLACK`` times the
   measured step.  Printed: the measured step, the bound and its dominant
   term, the ideal step over the measured one (its roofline fraction) and
   the predicted against the measured memory.
15. tp         — tensor-parallel serving on the continuous engine, each
   world of ranks spawned from here (``launch/mesh.py::spawn``), the
   ranks of every world but the last processes on this one card over
   gloo: yi-6b at full width cut to ``TP_YI_LAYERS`` layers under
   ``default=plam_sim:16:1``, each rank drawing its shard of the seeded
   init and encoding it to int16, at tp = 2 on the serve phase's 4
   requests (served at tp = 1 here at that depth), plainly and with
   chunked prefill and n-gram spec; yi-6b cut to ``TP_CUT_LAYERS`` at tp =
   8 (its 4 kv heads < 8: each rank keeps the kv head its q heads read);
   granite-moe-1b-a400m (TP inside each expert, its vocab of 49,155 kept
   whole) and deepseek-moe-16b at full width cut to ``TP_CUT_LAYERS`` at
   tp = 2; yi-6b at ``TP_YI_LAYERS`` at tp = 1 in a world of one over
   nccl.  Gates: each rank's launches a forward (7L+1 K1 at the sharded
   shapes ``TP_YI_K1``, the MoE models' 3L over their expert stacks; L K2
   a decode step on H/tp q heads and the rank's kv heads), no plain K1
   or codec call, K1 bit for bit against its plain version at every
   (M, K, N) a rank launched (expert stacks included), K2 within K5's
   gates on a decode step's operands, every rank's tokens equal, and
   rank 0's equal to the tp = 1 run's (phase serve's for yi-6b, else
   served here) or parting only where the tp = 1 context's top-2 margin
   is below ``E2E_LOGIT_TOL``.  Printed beside the card's name and power
   limit (every rank shares the card: no multi-card figure): each world's
   backend and size, each rank's peak memory, the step p50 at tp = 1 and
   tp = 2, K1's device times at the sharded shapes (rank 0, the others
   held at a barrier) and the collectives' share of a decode step.
16. tp_train   — training over a (data 2 x model 2) mesh: one world of
   four ranks spawned from here, sharing this one card over gloo, each
   drawing its shard of the seeded init, at phase train's settings
   (posit_quant:16:1, bf16, remat, AdamW at lr 1e-3, a global batch of
   8 x 128 from ``lm_batch``, each data rank its rows; ZeRO-1 AdamW
   state): yi-6b at full width cut to ``TP_TRAIN_LAYERS`` layers (gloo's
   traffic through host memory sets the phase's time) for
   ``TP_TRAIN_STEPS`` steps, its
   whole leaves gathered and written by rank 0 after
   ``TP_TRAIN_CKPT_AFTER``; granite-moe-1b-a400m at full width cut to
   ``TP_TRAIN_MOE_LAYERS`` for ``TP_TRAIN_MOE_STEPS``; yi-6b at
   ``TP_TRAIN_EXACT_LAYERS`` layers with f32 parameters, activations and numerics, one sharded step against one
   rank's on rank 0.  Then the checkpoint is restored here on one rank,
   which takes the remaining steps (elastic restore).  Gates: every
   rank's losses equal; step 0 within ``TP_TRAIN_LOSS_RTOL`` of one
   rank's (phase train's and train_families' where they ran, else a
   forward here); losses finite, and batch 0's after the steps below its
   step-0 loss; each rank's K3 quantizes a
   step by ``family_quantize_count`` (28L+4 for yi-6b), confirmed by a
   no-grad forward; no plain codec call on the card; K3 bit for bit at
   each (shape, dtype) rank 0 launched; each rank's m + v bytes the
   per-device count of ``zero1_dims`` on the stacked leaves; yi-6b's
   collectives a step by ``tp_train_collectives``; the f32 step's loss
   and parameters within ``TP_TRAIN_EXACT_TOL`` of one rank's and its m
   and v within ``TP_TRAIN_EXACT_MOMENT_ATOL`` + ``TP_TRAIN_EXACT_TOL``
   of theirs; the restored run's first loss within
   ``TP_TRAIN_LOSS_RTOL`` of the world's.  Printed beside the card's
   name and power limit: the world's backend and ranks, each step's
   seconds, per-rank peak memory and state bytes, the collectives a step
   and their share of the last step, the checkpoint's and the restore's
   seconds.
17. tp_ssm     — the state-space and hybrid families over a (data 2 x
   model 2) mesh: one world of four ranks spawned from here, sharing this
   card over gloo (over nccl with a card a rank).  (a) mamba2-780m and
   zamba2-1.2b at full width and depth under default=plam_sim:16:1 with
   int16 prequantized seeded weights, each rank its shard (in_proj cut
   block by block, the shared block column- and row-parallel): the
   prefill of ``TP_SSM_PROMPT`` seeded tokens (each data rank its rows)
   and ``TP_MESH_DECODE`` greedy decode steps; (b) zamba2 at global batch
   1, its shared K/V positions over ``data``; (c) ``TP_MESH_TRAIN_STEPS``
   AdamW steps of each under its config's posit_quant:16:1 with ZeRO-1
   state, phase train's global batch (8 x 128), built by the dry run's
   ``build_cell`` on the card and cut in depth to ``TP_SSM_TRAIN_LAYERS``;
   (d) each of those cells dry-run on this rank's ``VirtualMesh`` (meta);
   (e) (a) and (b) again with f32 parameters, activations, numerics and
   caches, TF32 off: the prefill and ``TP_MESH_F32_DECODE`` teacher-forced
   decode steps.
   Gates: the tokens of (a) and (b) equal one rank's (served here) or
   parting only where its top-2 margin is below ``TP_MESH_MARGIN``; the
   logits of (e) within ``TP_MESH_F32_TOL`` of one rank's, relative to
   its largest |logit| (a gate that does not ride on bf16's near ties); K1
   launches a forward 2L+1 (mamba2) and 2L+8L/6+1 (zamba2), no plain K1
   or codec call, K1 bit for bit against its plain version at every
   (M, K, N) rank 0 launched; every rank's losses equal, step 0 within
   ``TP_TRAIN_LOSS_RTOL`` of one rank's, K3 quantizes a step by
   ``family_quantize_count``, bit for bit at rank 0's (shape, dtype), m + v
   bytes the per-device ZeRO-1 count, the collectives a step by
   ``tp_ssm_collectives``; (d) the virtual mesh's launches and collectives
   (axis, kind, calls, result bytes) equal to each rank's measured ones,
   and its peak within ``DRYRUN_MEM_TOL`` of the measured one.
18. tp_encdec  — the encoder-decoder and vlm families over the same
   (data 2 x model 2) mesh, one world of four ranks.  (a) f32 forms of
   the serving runs below (f32 parameters, activations, numerics and
   caches, TF32 off; qwen2-vl at ``TP_ENCDEC_VLM_F32_LAYERS`` layers):
   the prefill and ``TP_MESH_F32_DECODE`` teacher-forced decode steps,
   the logits within ``TP_MESH_F32_TOL`` of one rank's largest
   |logit|; (b) seamless-m4t-medium at full width and depth and
   qwen2-vl-72b at full width cut to ``TP_ENCDEC_VLM_LAYERS`` layers,
   default=plam_sim:16:1 with int16 prequantized seeded weights, served
   through the registry's static entry points at phase archs' prompts
   (each data rank its rows of the frames or patch embeddings and
   tokens) and ``TP_MESH_DECODE`` greedy steps, each data rank's
   tokens against one rank's run of the same rows (a departure only
   where its top-2 margin is below ``TP_MESH_MARGIN``); (c) K1 73 an
   encoder pass and 121 a decoder forward (seamless), 7L+1 (qwen2-vl) a
   forward per rank, no plain K1 or codec call, rank 0's K1 bit for bit
   at every (M, K, N) it launched (rows 0-63 and the last 64-row block);
   (d) the collectives over ``model`` a forward by hand
   (``tp_encdec_collectives``); (e) every serving cell and training step
   dry-run on the rank's ``VirtualMesh``: launches and collectives equal
   to the rank's, the peak within ``TP_ENCDEC_SERVE_MEM_TOL`` (serving)
   and ``TP_ENCDEC_STEP_MEM_TOL`` (a step).  Training:
   ``TP_MESH_TRAIN_STEPS`` AdamW steps with ZeRO-1 state of seamless
   under its posit_quant:16:1 (``TP_ENCDEC_TRAIN_LAYERS`` encoder and
   decoder layers), phase train's global batch, with phase tp_ssm's
   training gates (step 0 within ``TP_TRAIN_LOSS_RTOL`` of one rank's, m
   + v the per-stack ZeRO-1 count); qwen2-vl-72b at
   ``TP_ENCDEC_VLM_TRAIN_LAYERS`` layers trains only with a card a rank
   (nccl), and on one card its step is counted on the virtual mesh
   against the hand count.

It exits non-zero if any phase fails, if no CUDA device is present, or if
``repro_torch`` cannot be imported.  Its last line is
``{"ok": true, "device": {...}}`` and nothing is printed there otherwise.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ["device", "kernels", "conformance", "serve", "serve_paths", "observe", "moe",
          "static", "archs", "train", "train_families", "e2e", "times", "dryrun", "tp",
          "tp_train", "tp_ssm", "tp_encdec"]

# H100 SXM peaks (NVIDIA data sheet), from the port's roofline, the one
# source of them: HBM3 bytes/s, f32 CUDA-core FLOP/s, SMs and the INT32
# lanes of each.  Without the repository's sources main() says so.
try:
    from repro_torch.launch.roofline import (  # noqa: E402
        HBM_BW as HBM_BYTES_PER_S,
        INT32_LANES_PER_SM,
        PEAK_F32 as F32_FLOPS,
        SMS,
    )
except ImportError:
    HBM_BYTES_PER_S = F32_FLOPS = SMS = INT32_LANES_PER_SM = None
# lane instructions an SM starts a clock: 4 warp schedulers of 32 lanes
INSTR_LANES_PER_SM = 128
# clock cycles (~0.1 ms) of the device spin that events_ms(spin=True) queues
# before a timed call
SPIN_CYCLES = 200_000

K1_SHAPES = [  # (K, N) of yi-6b's projections and lm_head
    (4096, 4096),    # wq, wo
    (4096, 512),     # wk, wv
    (4096, 11008),   # wg, wu
    (11008, 4096),   # wd
    (4096, 64000),   # unembed
]
RAGGED_SHAPES = [(4, 5, 3), (1, 7, 1), (3, 130, 9), (9, 257, 5), (2, 1, 2), (17, 64, 33)]
# (M, K, N) at the edges of K1's decode path (M <= 16): k-tiles of 2048/BN
# rows, a ring of 4 stages, strips of BN columns, 16-byte vector loads
# (N % 8 == 0 for int16, N % 4 == 0 for int32) or scalar ones, and the
# M <= 4 / M <= 16 branches.  RAGGED_SHAPES and K1_EDGE_SHAPES are copies
# of tests/test_torch_kernels.py's RAGGED_SHAPES and EDGE_SHAPES, which
# own them (a test there holds the copies equal); this script runs
# without the tests.  The wide shapes are too large for the CPU tests.
K1_EDGE_SHAPES = [(4, 1023, 8), (4, 1025, 9), (3, 4097, 16), (1, 4097, 12), (5, 513, 24),
                  (16, 511, 17), (2, 300, 40)]
K1_WIDE_EDGE_SHAPES = [(4, 4096, 4104), (4, 2048, 520), (16, 4096, 4100), (7, 1000, 64008)]
# (M, K, N) at the edges of K1's prefill path (M > 16): 64-row blocks (M =
# 17, 63, 64, 65, 128, 256), 32-deep k-tiles in a 3-stage ring (K = 31,
# 33, 64, 96, a ragged tail at 1000, 4095, 4097), scalar A loads (K % 8 !=
# 0) and scalar B loads (N % 8 != 0: 17, 33, 511, 2113, 4100, 4225, 8449),
# and N at each strip width's wave edge on 132 SMs (2112 | 2113 for 16 | 32
# columns, 4224 | 4225 for 32 | 16, 8448 | 8449 for 64 | 16).  Every odd
# case has zero and NaR patterns planted in a middle k-tile of A and B, a
# slow tile between fast ones.  A copy of tests/test_torch_kernels.py's
# PREFILL_EDGE_SHAPES, which owns it (the CPU tests run it cut to K <= 300).
K1_PREFILL_EDGE_SHAPES = [(17, 31, 16), (63, 33, 17), (64, 4095, 33), (65, 4097, 511),
                          (128, 4096, 4100), (256, 1000, 512), (17, 64, 16), (64, 96, 4104),
                          (48, 4096, 2112), (48, 4096, 2113), (64, 4096, 4224), (64, 2048, 4225),
                          (48, 1024, 8448), (33, 1024, 8449)]
# M of decode batches with 1-4 live slots, and the M <= 16 branch's top
K1_DECODE_MS = (1, 2, 3, 4, 16)
# K1's decode floor: ALU-pipe operations of one log_word and of one
# product row, counted by hand in the header of its source
K1_SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "plam_matmul.cuh")
# K1 over float activations: (M, K, N) beyond M in K1_FUSED_MS at K = N =
# 4096, at M = 4 and 64: an odd K (bf16 rows then start off 4 bytes and
# are read with guarded 2-byte loads) and N that is not a multiple of 8
K1_FUSED_KN = [(4096, 512), (4096, 11008), (4096, 4100), (33, 4096), (4095, 4096),
               (33, 4100), (4095, 11008)]
K1_FUSED_MS = (1, 2, 3, 4, 5, 16, 17, 64)
# M at which the serve path calls K1 over bf16 activations: a decode step
# with 4 slots, and prefills of prompts padded to 48 and 64 tokens; the
# fused kernel is checked at every K1_SHAPES (K, N) at each of them
K1_SERVE_MS = (4, 48, 64)
# M of the multi-token paged path (phase serve_paths): the verify rows,
# 4 slots x (spec_k = 4 drafts + 1), and the chunk width (32; the ragged
# final chunk is 16 or 32).  The fused kernel is checked (bf16 A) and
# timed at every K1_SHAPES (K, N) at each of them.
K1_CHUNK_MS = (20, 32)
# phase serve_paths: the chunk width and the speculative burst
SERVE_CHUNK = 32
SERVE_SPEC_K = 4
# phase observe: the engine's profiler spans, and the serve CLI's run (the
# serve phase's width and depth, prompts of 64 tokens); the CLI is given
# this long to build its model and serve
OBSERVE_SPANS = ("serve.prefill", "serve.decode", "serve.verify", "serve.scrub", "serve.cow")
OBSERVE_CLI = ["--arch", "yi-6b", "--continuous", "--prequantized", "--numerics-policy",
               "default=plam_sim:16:1", "--batch", "4", "--prompt-len", "64",
               "--new-tokens", "16"]
OBSERVE_CLI_TIMEOUT_S = 300
# the prefix-cache request set: a shared 48-token prefix (3 blocks), four
# suffixes (the first 16 tokens, so that its prompt is block-aligned and
# the fifth request, its exact repeat, copies on write)
PREFIX_LEN = 48
PREFIX_SUFFIX_LENS = (16, 8, 12, 14)
# every PLANT-th activation of those checks is a sweep value (most lie
# outside the exact bf16 range), so that both of a_word's branches run
# in one warp, as on the serve path's own activations
PLANT = 5
# Posit<16,1>: the bf16 scales at which a value is its own A word
# (posit.cuh derives them from the spec); the share of the serve path's
# activations outside them is logged beside the fused call's time
EXACT_BF16_SCALES = (-12, 11)
# K1 fused beside the codec-then-matmul pair: yi-6b's projections at M = 4,
# and at the prefill M of the serve phase's prompts (32-64 tokens, padded
# to 16-token blocks: 48 and 64) wg/wu at 64 and wq/wo, wk/wv, wd at 48
K1_PAIR_RUNS = ([(4, s) for s in K1_SHAPES] + [(64, (4096, 11008))]
                + [(48, s) for s in ((4096, 4096), (4096, 512), (11008, 4096))])
# back-to-back wrapper calls whose host time is averaged, behind a device
# spin long enough (~20 ms) that the card never drains the queue
HOST_CALLS = 200
HOST_SPIN_CYCLES = 40_000_000
# K3's bound and design floor: the ALU-pipe operations a bf16 encode lane
# needs (a table encode) and those of its design, counted by hand in the
# header of its source
K3_SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "posit_codec.cu")
# K3's encode paths: the card's bf16 table against its plain version at
# K3_TABLE_SPECS, and the table and computed paths at K3_PATH_SPECS
# (copies of tests/test_torch_kernels.py's TABLE_SPECS and
# TABLE_PATH_SPECS, which a test there holds equal)
K3_TABLE_SPECS = [(16, 1), (16, 2), (16, 0), (12, 1), (10, 1), (8, 1), (8, 0), (6, 0)]
K3_PATH_SPECS = [(16, 1), (16, 2), (10, 1), (8, 0)]
# the weight shapes the serve path encodes at which K3 is held against
# its plain version (wk/wv: 64 blocks; wg/wu: the grid capped at the SMs;
# the unembed: the longest loop; a copy of the test file's WEIGHT_SHAPES,
# held equal there)
K3_WEIGHT_SHAPES = [(4096, 512), (4096, 11008), (4096, 64000)]
# the K3_TIMES shapes whose host time per call is read: the table path
# (wk/wv) and the computed path (a decode activation)
K3_HOST_SHAPES = [(4096, 512), (4, 4096)]
# K3's decode and quantize (the conformance oracle's): (operation, input)
# at each of K3_OTHER_LANES, Posit<16,1> (2^24 lanes, and the 4,096 lanes
# of a Posit<16,1> vector file)
K3_OTHER_TIMES = [("decode", "int16"), ("decode", "int32"), ("quantize", "f32"),
                  ("quantize", "bf16")]
K3_OTHER_LANES = (1 << 24, 4096)
# the decode's check at full weight size: all 65,536 patterns tiled and
# shuffled to more lanes than its grid takes in two chunks a thread
# (2112 blocks x 256 threads x 2 x 8 lanes = 8.65 M)
K3_DECODE_BIG_LANES = (1 << 24) + 13
# variants of posit_codec.cu that phase times builds beside it (each a
# list of (text, replacement) over its source): the decode's and quantize's
# first form (the design before the current one: one lane a thread, the
# spec at run time), the computed paths with one lane a thread and with 8-lane
# chunks at every size, the table paths with two blocks an SM, and the
# fill probe's two
K3_VARIANTS = {
    "first form": [("const bool by_lane = n < by_lane_max;", "const bool by_lane = true;"),
                   ("if (posit_n == 16 && posit_es == 1)", "if (false)")],
    "by lane": [("const bool by_lane = n < by_lane_max;", "const bool by_lane = true;")],
    "by chunk": [("const bool by_lane = n < by_lane_max;", "const bool by_lane = false;")],
    "two blocks an SM": [("want < sms ? want : sms", "want < 2 * sms ? want : 2 * sms")],
    "no fill": [("for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x) "
                 "smem[i] = src[i];", "(void)src;")],
    "65536 lanes a block": [("constexpr int kTableLanesPerBlock = 32768;",
                             "constexpr int kTableLanesPerBlock = 65536;")],
}
# the computed paths' lane counts timed on both sides of their thresholds
# of one lane a thread (kDecodeByLaneMaxLanes 2^17, kByLaneMaxLanes 2^20):
# the design against "by lane" and "by chunk", raw launches in turns,
# decode int16, quantize bf16 and f32
K3_BY_LANE_SWEEP = [4096, 65536, (1 << 17) - 1, 1 << 17, 1 << 18, 1 << 19, (1 << 20) - 1,
                    1 << 20, 1 << 22]
# the quantize's bf16 lane counts timed on both sides of TABLE_MIN_NUMEL,
# table path against computed path in turns: 2^19, mamba2-780m's training
# activation [1024, 1536] and yi-6b's [1024, 4096]
K3_TABLE_EDGE_SHAPES = [(1 << 19,), (1024, 1536), (1024, 4096)]
# K3's calls in one posit_quant decode step of mamba2-780m on prequantized
# weights at phase static's batch of 4: (op, shape, input, calls a decode
# step, calls a prefill), each int16 weight decoded and each bf16
# activation quantized (2L + 1 each; a prefill quantizes its last
# position's [4, 1, 1536] for the head); phase static holds its recorded
# calls to this list, and phase times sums a decode step's, the design
# against the first form
K3_STEP_CALLS = [("decode", (1536, 6448), "int16", 48, 48),
                 ("decode", (3072, 1536), "int16", 48, 48),
                 ("decode", (1536, 50280), "int16", 1, 1),
                 ("quantize", (4, 1, 1536), "bf16", 49, 1),
                 ("quantize", (4, 1, 3072), "bf16", 48, 0)]
# the table paths' probe (Smoke.time_table_fill): the encode's shapes and
# outputs, and the quantize's shapes (mamba2-780m's in_proj, 2^24 lanes)
K3_FILL_SHAPES = [((4096, 512), "int16"), ((4096, 11008), "int16"),
                  ((4096, 11008), "int32"), ((4096, 64000), "int16")]
K3_FILL_QUANT_SHAPES = [(1536, 6448), (1 << 24,)]
# K3's timed calls, (shape, input, output): a wg/wu weight (engine build,
# and every forward without prequantized weights) to int16 and int32, wk/wv
# (where the table fill's share shows), the unembed, the wg/wu weight over
# uniformly random finite bf16 bit patterns (the lookups' bank spread), an
# f32 weight (computed path) and the activation shapes (computed path)
K3_TIMES = [((4096, 11008), "bf16", "int16"), ((4096, 11008), "bf16", "int32"),
            ((4096, 512), "bf16", "int16"), ((4096, 64000), "bf16", "int16"),
            ((4096, 11008), "bf16 bits", "int16"), ((4096, 11008), "f32", "int32"),
            ((4, 4096), "bf16", "int32"), ((64, 11008), "bf16", "int32")]
# K2 tolerances.  The kernel keeps scores, probabilities and sums in f32
# and rounds once to bf16 at the end, so against the plain version run in
# f32 it differs by that rounding (2^-9 of |out| <= 1 here) and sum order.
# The plain version at bf16 also rounds the unscaled scores (|q.k| ~ 35,
# ulp 0.25) and the softmax weights to bf16 before the weighted sum, which
# moves the output by up to a few 1e-2.
K2_TOL_F32 = 1e-2
K2_TOL_BF16 = 6e-2
# K2 at a long paged context: K5's lengths over yi-6b's widths, 16-key
# pool blocks, 256 table entries a sequence
K2_LONG_LENGTHS = [1000, 2048, 3001, 4096]
K2_LONG_MAX_BLK = 256
# lengths at the edges of K2's and K5's core: 0 (every key masked), 1, a
# 16-key tile (K2's pool block) +- 1, a round of a block's tiles +- 1 (64
# keys with four warps, 128 with eight); the checks add the split plan's
# edge +- 1 and the full cache
LENGTH_EDGES = [0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129]
# Phase 4: K1 and K3 are bit-identical to their plain versions, so the
# two runs differ only through K2's rounding (above), which the posit
# encoding of the next activations can amplify to a pattern step
# (2^-12 relative); logits are ~N(0, 1) at random init.
E2E_LOGIT_TOL = 0.1
# The MoE family (phase moe): each arch's expert count and its expert
# projections (K, N), wg/wu then wd
MOE_ARCHS = ("deepseek-moe-16b", "granite-moe-1b-a400m")
MOE_EXPERTS = {"deepseek-moe-16b": 64, "granite-moe-1b-a400m": 32}
MOE_SHAPES = {"deepseek-moe-16b": [(2048, 1408), (1408, 2048)],
              "granite-moe-1b-a400m": [(1024, 512), (512, 1024)]}
# K1 over a stack of experts: the M (cap) of an expert's buffer.  At
# deepseek's widths: 1 a decode step at 4 slots, 2 a verify over 4 x 5
# rows, 3 a 32-token chunk, 5 and 7 the serve prompts' prefills padded to
# 48 and 64 tokens, 60 a 512-token prompt (the prefill path); at
# granite's: 1 a decode step, 15 and 20 those two prefills.  Phase moe
# also records the caps its runs reach and holds the kernel at each of
# them.  The grouped plain version runs over the first K1_GROUPED_PLAIN_E
# experts (cut experts, never K or N); the grouped kernel is held to the
# 2-D kernel over all of them.
K1_GROUPED_MS = (1, 2, 3, 5, 7, 15, 20, 60)
K1_GROUPED_PLAIN_E = 8
# E = 3 stacks at ragged (M, K, N): scalar loads, a ragged k tail, the
# prefill path's 64-row edge; zero and NaR planted
K1_GROUPED_RAGGED = [(17, 33, 17), (5, 1025, 9), (65, 4097, 511)]
# granite's unembed (odd N), at a decode step's M and a prefill's
K1_GRANITE_UNEMBED = (1024, 49155)
K1_GRANITE_UNEMBED_MS = (4, 64)
# times: the grouped kernel at deepseek's expert projections and the M of
# a decode step and a prefill
K1_GROUPED_TIME_MS = (1, 7)
# The static engine and the state-space families (phase static): mamba2-780m
# and zamba2-1.2b at their configs' full width and depth; STATIC_BATCH
# seeded prompts of STATIC_PROMPT tokens and STATIC_NEW new tokens, then
# STATIC_LONG_BATCH of STATIC_LONG_PROMPT (three SSD chunks of 128, the
# last padded with dt = 0); yi-6b on the static engine at full width cut
# to STATIC_YI_LAYERS layers (or fewer with --layers), against the
# continuous engine, and a STATIC_DRAFT_LAYERS-layer draft of its widths
# on its own seeded weights drafting STATIC_SPEC_K tokens for it; the
# serving CLI without --continuous
STATIC_ARCHS = ("mamba2-780m", "zamba2-1.2b")
STATIC_BATCH, STATIC_PROMPT, STATIC_NEW = 4, 64, 16  # STATIC_NEW: serve_run's 16
STATIC_LONG_BATCH, STATIC_LONG_PROMPT = 2, 320
STATIC_YI_LAYERS = 4
STATIC_DRAFT_LAYERS = 2
STATIC_SPEC_K = 4
STATIC_CLI = ["--arch", "mamba2-780m", "--prequantized", "--batch", "4", "--prompt-len",
              "64", "--new-tokens", "8"]
STATIC_CLI_TIMEOUT_S = 300
# K1 at the state-space families' projections (K, N), timed at a decode
# step's M and a prefill's (STATIC_BATCH x STATIC_PROMPT rows)
STATIC_K1_SHAPES = {"mamba2-780m": [(1536, 6448), (3072, 1536), (1536, 50280)],
                    "zamba2-1.2b": [(2048, 8384), (4096, 2048), (4096, 4096), (4096, 8192),
                                    (8192, 4096), (2048, 32000)]}
# The other five architectures (phase archs), under default=plam_sim:16:1:
# gemma-7b and minitron-8b at full depth on both engines, command-r-plus-
# 104b on the continuous engine and qwen2-vl-72b on the static engine cut
# to ARCHS_LAYERS layers (widths never cut; the memory that sets each cut is
# in PERF.md), seamless-m4t-medium at full depth on the static engine.
# ARCHS_BATCH prompts of ARCHS_PROMPT seeded tokens (one length, so that the
# static engine takes the same prompts), ARCHS_NEW new tokens, blocks of 16
# and 4 slots; seamless: ARCHS_FRAMES seeded frames a row and an
# ARCHS_TGT-token target prefix; qwen2-vl: VLM_ROWS rows of the registry's
# 1,024 seeded patch embeddings and VLM_TOKENS tokens.  K1 is held bit for
# bit at each (M, K, N) the runs launch, on the first launch's operands,
# over its first K1_ROWS rows and its last 64-row block (rows are
# independent); where B is made in the forward (a tied head's embed.T, bf16
# weights) over its first and last K1_COLS columns (so are columns).  Each
# of the five also runs at ARCHS_E2E_LAYERS layers on the kernels and on
# the plain versions (phase e2e's rule).
ARCHS_DENSE = ("gemma-7b", "minitron-8b", "command-r-plus-104b")
ARCHS_STATIC = ("seamless-m4t-medium", "qwen2-vl-72b")
# (cut further for the whole script's time; PERF.md section 6)
ARCHS_LAYERS = {"command-r-plus-104b": 8, "qwen2-vl-72b": 12}
ARCHS_BOTH_ENGINES = ("gemma-7b", "minitron-8b")
ARCHS_BATCH, ARCHS_PROMPT, ARCHS_NEW = 4, 48, 16  # ARCHS_NEW: serve_run's 16
ARCHS_FRAMES, ARCHS_TGT = 256, 16
VLM_ROWS, VLM_TOKENS = 2, 32
ARCHS_E2E_LAYERS = 2
K1_ROWS, K1_COLS = 64, 512
# mitchell_f32 (phase e2e): nmatmul at yi-6b's projections at M = 4 on the
# card against the CPU over the first MITCHELL_CPU_N columns (columns are
# independent; the CPU would take minutes over the unembed's 64,000).  The
# two add the same f32 products in another order within each 64-wide
# chunk: rtol 1e-5, and an atol of 1e-6 for sums that cancel to near zero
# (|out| is ~1 here)
MITCHELL_M = 4
MITCHELL_CPU_N = 1024
MITCHELL_RTOL = 1e-5
MITCHELL_ATOL = 1e-6
# phase train: K1's plain version over row slices of at most
# K1_PLAIN_LANES lanes of A and of the output (its int64 and int32
# temporaries), when it is held to a recorded launch
K1_PLAIN_LANES = 1 << 26
# experts of a recorded K1 launch over a stack held to the plain version:
# the first this many, and the last
K1_GROUPED_CHECKED = 8
# K3's quantize at the training path's shapes (yi-6b, batch 8 x seq 128 =
# 1024 tokens): every weight of a block and the unembed, bf16 and f32, and
# the two activation widths
K3_QUANT_WEIGHT_SHAPES = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096),
                          (4096, 64000)]
K3_QUANT_ACT_SHAPES = [(1024, 4096), (1024, 11008)]
# ... and the 3-D expert stacks of phase train_families (deepseek-moe-16b's
# [E, d_model, d_expert], granite-moe-1b-a400m's [E, d_expert, d_model])
K3_QUANT_STACK_SHAPES = [(64, 2048, 1408), (32, 1024, 512)]
# phase times: K3 quantize at the training path's two largest weights and
# an activation, then at phase train_families' new weights (deepseek's and
# granite's expert stacks, qwen2-vl-72b's unembed, mamba2-780m's in_proj)
K3_QUANT_TIMES = [((4096, 11008), "bf16"), ((4096, 64000), "bf16"), ((1024, 4096), "f32"),
                  ((64, 2048, 1408), "bf16"), ((32, 1024, 512), "bf16"),
                  ((8192, 152064), "bf16"), ((1536, 6448), "bf16")]
# phase train: full-width yi-6b cut to TRAIN_LAYERS layers (AdamW's f32 m and
# v over all 32 layers' 6.06 B parameters are 48.5 GB and bf16 parameters
# and gradients 24.2 GB more, which leaves no safe room on 80 GB for the
# activations and the codec's f32 outputs), TRAIN_STEPS AdamW steps at the
# CLI's defaults (seq 128, batch 8, lr 1e-3)
TRAIN_LAYERS = 8
TRAIN_STEPS = 6
TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR = 128, 8, 1e-3
# phase train_families: every other family trained at full width under its
# config's own posit_quant:16:1, at phase train's settings (TRAIN_STEPS
# AdamW steps, batch 8 x seq 128, TF32 off).  Reckoned at 12 bytes a
# parameter (bf16 weights and gradients, f32 m and v), two are cut in
# depth, never in width: deepseek-moe-16b to 4 of 28 layers (0.59 G a
# layer and 0.42 G of embedding and unembedding: 2.77 G, 33 GB) and
# qwen2-vl-72b to 2 of 80 (0.878 G a layer and 2.49 G of untied
# embeddings: 4.25 G, 51 GB, and ~15 GB of AdamW's f32 temporaries over its
# 1.25 G-element unembed)
FAMILY_ARCHS = ("mamba2-780m", "zamba2-1.2b", "granite-moe-1b-a400m", "deepseek-moe-16b",
                "seamless-m4t-medium", "qwen2-vl-72b")
FAMILY_LAYERS = {"deepseek-moe-16b": 4, "qwen2-vl-72b": 2}
FAMILY_VLM_ROWS = 2  # rows of 1,024 patch embeddings and TRAIN_SEQ tokens
FAMILY_PROFILED = ("mamba2-780m", "deepseek-moe-16b")
# the SSD scan forms exp(dec) over a whole chunk and masks its upper
# triangle after it, as the reference does: past F32_EXP_MAX the masked
# exp is inf and the backward's 0 x inf NaN.  At TRAIN_LR the state-space
# models' dt grows past it within two steps (AdamW moves every in_proj
# weight by ~lr a step); they are trained again at FAMILY_SSM_LR
F32_EXP_MAX = 88.72
FAMILY_SSM_LR = 5e-5
# a trained MoE model served on the kernels and on the plain versions:
# K2's plain version rounds its softmax weights to bf16 and the kernel
# does not, and a decode step's capacity of 1 row an expert turns a
# near-tie in the router's top-k into another output.  A third run, the
# kernels with K2 alone on its plain version, must not part from the plain
# run at all (so K2's rounding is the one cause); the kernels' run may part
# from it where the router's k-th and next probabilities lie within
# MOE_ROUTE_TOL, or at a token pick under the serve-paths margin rule.  The
# largest difference of a router probability between the two runs before
# they part is printed beside it (3.69e-3 on an H100 for the trained
# deepseek-moe-16b): K2's rounding can swap two experts up to twice that
# apart, so MOE_ROUTE_TOL lies well inside what it can do
MOE_ROUTE_TOL = 1e-3
# the trained models served under default=plam_sim:16:1, prequantized, on
# the kernels and on the plain versions (whose K1 decodes every weight on
# every forward, ~3 s a deepseek forward and ~6.5 s a mamba2 one: few new
# tokens, and short prompts on the static engine)
FAMILY_SERVED = ("mamba2-780m", "deepseek-moe-16b")
FAMILY_SERVE_PROMPT, FAMILY_SERVE_NEW = 16, 4
# each family at 2 layers (the hybrid at its first shared block's 6) on
# the kernels and on the plain versions: one row of FAMILY_PLAIN_SEQ
# positions (the vlm's half patches)
FAMILY_PLAIN_LAYERS = 2
FAMILY_PLAIN_SEQ = 128
# yi-6b at full width cut to BLOCKWISE_LAYERS, f32 parameters, activations
# and numerics: one batch with flash_block=BLOCKWISE_BLOCK, one without,
# within the CPU tests' f32 tolerances (tests/test_torch_blockwise_attention.py)
BLOCKWISE_LAYERS, BLOCKWISE_BATCH, BLOCKWISE_SEQ, BLOCKWISE_BLOCK = 2, 2, 1024, 128
BLOCKWISE_LOSS_RTOL, BLOCKWISE_GRAD_TOL = 1e-5, 1e-4
# the CLI's fault drill, and its resumed losses against an uninterrupted run
TRAIN_CLI = ["--arch", "yi-6b", "--reduced", "--steps", "8", "--ckpt-every", "2",
             "--simulate-failure", "5"]
TRAIN_RESUME_RTOL = 1e-3
TRAIN_CLI_TIMEOUT_S = 300
# the paper's Table II setups (benchmarks/table2_accuracy.py:36-43): name,
# model, widths, data and training sizes
TABLE2_SETUPS = [
    ("isolet-syn", "mlp", (617, 128, 64, 26), dict(n=4000, epochs=12, lr=1e-3)),
    ("ucihar-syn", "mlp", (561, 512, 512, 6), dict(n=4000, epochs=10, lr=1e-3)),
    ("mnist-syn", "lenet5", dict(hw=28, ch=1, classes=10), dict(n=3000, epochs=8, lr=1e-3)),
    ("svhn-syn", "lenet5", dict(hw=28, ch=3, classes=10), dict(n=3000, epochs=8, lr=1e-3)),
    ("cifar10-syn", "cifarnet", dict(hw=32, ch=3, classes=10), dict(n=3000, epochs=8, lr=1e-3)),
]
# the reference's own Table II rows, from `python benchmarks/table2_accuracy.py
# --quick` on the CPU (its two MLP rows at n = 2200, 6 epochs): top-1 f32,
# posit16, plam16, then top-5 f32, posit16, plam16
TABLE2_QUICK = dict(n=2200, epochs=6)
TABLE2_REFERENCE_QUICK = {"isolet-syn": (0.8200, 0.8200, 0.8180, 0.9830, 0.9830, 0.9810),
                          "ucihar-syn": (0.9970, 0.9970, 0.9960, 1.0000, 1.0000, 1.0000)}
TABLE2_BAR = 0.02  # the reference's stated bar on plam16 - f32 top-1 (not gated)
CALIBRATE_BUDGET = 0.02
# K5 at yi-6b's widths: batch 4, 32 q heads over 4 kv heads, hd 128, a
# 4096-key contiguous cache with ragged lengths.
K5_SHAPE = dict(b=4, h=32, kv=4, hd=128, s=4096)
K5_LENGTHS = [1000, 2048, 3001, 4096]
# keys a block covers, timed beside the split plan's choice at K5's shape
K5_SPLIT_SWEEP = (128, 256, 512, 1024)
# the reference's shapes (tests/test_resilience.py): b, s, h, kv, hd, blk
K5_SMALL_SHAPES = [(2, 64, 8, 4, 16, 16), (1, 96, 4, 2, 32, 32)]
# K5 tolerances.  Kernel and plain version both compute in f32 and differ
# only in the order of the sums (over up to 4096 keys and across chunks):
# within K5_TOL_F32.  At bf16 the kernel rounds its f32 result once, to
# nearest, so each output lies within half a bf16 step of the plain
# version's f32 result on the same bf16 inputs (at most 2^-8 of its
# magnitude) plus the order term, K5_BF16_ORDER, ~10x the f32 difference
# measured at this shape.  The check is relative because |out| is only
# ~0.03-0.05 here: an absolute limit near 1e-2 would pass a truncating
# store or a lost chunk.
K5_TOL_F32 = 1e-4
K5_BF16_REL = 2.0 ** -8
K5_BF16_ORDER = 2e-6
# K2 is also held to K5's gates against the plain version's f32 result:
# the shared core computes both alike (inputs widened exactly to f32;
# scores, softmax and sums in f32; one rounding of the output), so an f32
# output lies within K5_TOL_F32 of it and a bf16 output within
# K5_BF16_REL |out| + K5_BF16_ORDER.  At 1000-4096 keys |out| is ~0.03:
# K2_TOL_F32 alone would pass a dropped 16-key tile or a misweighted split.
# Seeded random shapes on which K2 and K5 run with NaN in every element
# they must not read (CANARY_CASES of each; see check_canaries)
CANARY_CASES = 120
# K4's bound: the ALU-pipe operations a lane needs, counted by hand in
# the header of its source (no loop or address arithmetic).
K4_SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "posit_mul.cu")
K4_OPS = {"plam_mul_elementwise": "kPlamMulAluOpsPerLane",
          "exact_mul_elementwise": "kExactMulAluOpsPerLane"}
# phase dryrun: (arch, ShapeSpec fields, numerics policy or None for the
# config's own, prequantized weights, layers or None for the config's):
# the serving models at full width and depth, and phase train's step
DRYRUN_POLICY = "default=plam_sim:16:1"
DRYRUN_CELLS = [
    ("yi-6b", ("chip_decode", 64, 4, "decode"), DRYRUN_POLICY, True, None),
    ("mamba2-780m", ("chip_prefill", 64, 4, "prefill"), DRYRUN_POLICY, True, None),
    ("granite-moe-1b-a400m", ("chip_decode", 64, 4, "decode"), DRYRUN_POLICY, True, None),
    ("yi-6b", ("chip_train", TRAIN_SEQ, TRAIN_BATCH, "train"), None, False, TRAIN_LAYERS),
]
DRYRUN_STEPS = 3
# the dry run's peak bytes against the measured peak, and the roofline's
# bound time against the measured step (a bound above the step means the
# counts are wrong)
DRYRUN_MEM_TOL = 0.15
DRYRUN_BOUND_SLACK = 1.05
# phase tp: tensor-parallel serving, every rank a process on this one card
# (gloo), and a world of one over nccl.  yi-6b's K1 (K, N) at tp = 2: wq,
# wk/wv, wo, wg/wu, wd and the unembed, each rank's block
TP_YI_K1 = {(4096, 2048), (4096, 256), (2048, 4096), (4096, 5504), (5504, 4096),
            (4096, 32000)}
TP_FALLBACK = 8  # yi-6b's kv = 4 < 8: each rank keeps the kv head its q heads read
TP_CUT_LAYERS = 4  # the depth of the tp = 8 yi-6b and the MoE runs
# the depth of the tp = 2 and tp = 1 (nccl) yi-6b runs: cut from 32, with
# granite-moe-1b-a400m's from 24 to TP_CUT_LAYERS, when phase tp_ssm came, to
# keep the whole script inside its time limit (the gloo worlds' steps move
# through host memory, whose speed differs between machines: the whole script
# took 1237 s on one H100 at full depth here, PERF.md section 6)
TP_YI_LAYERS = 4
TP_K1_TIME_REPS = 10
TP_TIMEOUT_S = 600  # a spawned world's limit
# phase tp_train: training over a (data x model) mesh whose ranks share this
# one card over gloo, at phase train's settings (posit_quant:16:1, bf16,
# remat, AdamW at TRAIN_LR, global batch TRAIN_BATCH x TRAIN_SEQ, seed 0):
# yi-6b at full width for TP_TRAIN_STEPS steps with a checkpoint of
# whole leaves after TP_TRAIN_CKPT_AFTER, restored on one rank here (elastic
# restore); TP_TRAIN_MOE at full width, TP_TRAIN_MOE_LAYERS deep; yi-6b at
# TP_TRAIN_EXACT_LAYERS layers with f32 parameters and activations, one
# sharded step against one rank's.  The exactness run's AdamW eps is
# TP_TRAIN_EXACT_EPS: its first step divides each gradient element by its
# own magnitude plus eps, so at 1e-8 a gradient element near 0 would move
# its parameter by a share of lr set by its f32 rounding
# (tests/test_torch_tp_train.py)
TP_TRAIN_MESH = (2, 2)  # (data, model)
# yi-6b's depth: gloo moves each step's f32 gradients (3.8 GB a rank at
# phase train's 8 layers) and ZeRO-1's updated parameters through host
# memory, 17-18 s a step at 8 layers on the H100 (0.96 of it collectives)
# and 7-15 s at 4 (the host's throughput differs between machines): cut in
# depth, never in width, to keep the whole script inside its time limit (2
# until phase tp_ssm took the time)
TP_TRAIN_LAYERS = 1
TP_TRAIN_STEPS, TP_TRAIN_CKPT_AFTER = 4, 2
TP_TRAIN_MOE, TP_TRAIN_MOE_STEPS = "granite-moe-1b-a400m", 2
TP_TRAIN_MOE_LAYERS = 4  # cut from 24 for phase tp_ssm (the whole script's time)
TP_TRAIN_EXACT_LAYERS, TP_TRAIN_EXACT_EPS = 1, 1e-5  # 2 layers before phase tp_ssm
TP_TRAIN_LOSS_RTOL = 1e-3  # a step-0 loss against one rank's (the forward's sum order)
TP_TRAIN_EXACT_TOL = 1e-5  # the f32 step: loss (relative) and parameters (absolute)
TP_TRAIN_EXACT_MOMENT_ATOL = 1e-6  # m and v: within 1e-6 + 1e-5 |one rank's|
# the exactness step's policy and its parameters' tolerance: f32, the sum
# order alone.  (Under posit_quant:16:1 with an f32 carrier, K3 on both
# sides, an activation that the sharded sums put across a posit rounding
# boundary moves its gradient elements, and AdamW turns that, where an
# element is near eps, into up to a tenth of the step's move: 1.84e-5 on the
# H100, PERF.md section 6, PR 31; tests/test_torch_tp_train.py holds that
# case against the reference.  It left the phase for the script's time.)
TP_TRAIN_EXACT_POLICIES = {"f32": ("default=f32", TP_TRAIN_EXACT_TOL)}
TP_TRAIN_TIMEOUT_S = 900
# yi-6b at all 32 layers, where the world has a card a rank: at TRAIN_LR its
# loss rises (batch 0's 11.56 -> 12.66 over 4 steps on four H100s, PERF.md
# section 6, PR 31): AdamW's first steps move every weight by about lr, 6%
# of its init scale (d^-1/2), in the gradient's sign, and 32 layers compound
# it; the full-depth run takes a tenth of it
TP_TRAIN_FULL_LR = 1e-4
# phases tp_ssm and tp_encdec: one world of four ranks over a (data x
# model) mesh of TP_MESH, each data rank serving its rows of the prompts;
# TP_MESH_DECODE greedy decode steps after each prefill, and a bf16 token
# that parts from one rank's run of the same rows is a near tie where one
# rank's top-2 logit margin there is below TP_MESH_MARGIN.  The f32 forms
# (the prefill and TP_MESH_F32_DECODE teacher-forced steps) are the gate
# that tells a fault: their logits lie within TP_MESH_F32_TOL of one
# rank's, relative to its largest |logit|.  TP_MESH_TRAIN_STEPS AdamW steps
# with ZeRO-1 state a trained model.
TP_MESH = (2, 2)  # (data, model)
TP_MESH_DECODE = 8
TP_MESH_MARGIN = 0.1
TP_MESH_F32_DECODE = 2
TP_MESH_F32_TOL = 1e-3
TP_MESH_TRAIN_STEPS = 2
TP_MESH_TIMEOUT_S = 600
# phase tp_ssm: mamba2-780m and zamba2-1.2b over a (data x model) mesh whose
# ranks share this one card over gloo.  Serving at full width and depth
# (TP_SSM_PROMPT rows x tokens).  Training cut in depth only
# (gloo moves each step's gradients through host memory, and the whole
# script's time): mamba2 to 2 of 48 layers, zamba2 to 6 of 38 (one
# shared-block invocation).  The bf16 tokens part from one rank's at near
# ties that sum order alone moves (48 bf16 layers carry a change of f32
# sum order to top-logit gaps up to 0.17, PERF.md section 6), so the same
# forms also run in f32 at full depth, where the mesh moved the logits by
# 6e-6 to 8e-6 of the largest one (H100, PERF.md section 6) and a rank
# reading the wrong channels moves them by far more
# (tests/test_torch_tp_ssm.py holds TP_MESH_F32_TOL between the two at
# reduced size; relative to one rank's largest |logit|)
TP_SSM_ARCHS = ("mamba2-780m", "zamba2-1.2b")
TP_SSM_PROMPT = (4, 64)
TP_SSM_TRAIN_LAYERS = {"mamba2-780m": 2, "zamba2-1.2b": 6}
# phase tp_encdec: seamless-m4t-medium and qwen2-vl-72b over the same
# (data x model) mesh.  Serving at full width: seamless at full depth,
# qwen2-vl cut to TP_ENCDEC_VLM_LAYERS of 80 (four ranks' shards and
# their inits on one card), phase archs' prompts (ARCHS_BATCH rows of
# ARCHS_FRAMES frames and ARCHS_TGT target tokens; VLM_ROWS rows of 1,024
# patch embeddings and VLM_TOKENS tokens), each data rank its rows, then
# TP_MESH_DECODE greedy steps.  As in phase tp_ssm the f32 forms are
# the gate that tells a fault (tests/test_torch_tp_encdec.py holds
# TP_MESH_F32_TOL between the mesh's sum order and a rank reading the
# wrong heads at reduced size); a bf16 token departure is reported with
# one rank's top-2 margin, which must lie below TP_MESH_MARGIN.
# Training: seamless under its posit_quant:16:1 at TP_ENCDEC_TRAIN_LAYERS
# encoder and decoder layers (its full depth: a step's time is its
# vocabulary's, not its layers', PERF.md section 6); qwen2-vl at
# TP_ENCDEC_VLM_TRAIN_LAYERS only with a card a rank: four ranks on one
# card cannot hold its step (3.37 G parameters a rank with both data
# replicas, bf16 weights and gradients and ZeRO-1's f32 m and v pass 80
# GB).
TP_ENCDEC_ARCHS = ("seamless-m4t-medium", "qwen2-vl-72b")
TP_ENCDEC_VLM_LAYERS = 4
TP_ENCDEC_VLM_F32_LAYERS = 2
TP_ENCDEC_TRAIN_LAYERS = 12  # seamless's 12 + 12
TP_ENCDEC_VLM_TRAIN_LAYERS = 2
TP_ENCDEC_SERVE_MEM_TOL = 0.05
TP_ENCDEC_STEP_MEM_TOL = 0.10


def launch_counts(cfg, prequantized: bool = True) -> dict:
    """The kernel launches of ``cfg``'s model under default=plam_sim:16:1,
    where every projection is a plam_sim site: ``build``, the weight
    encodes (K3) of ``quantize_params``; ``k1`` and ``k3``, the K1 and K3
    launches of one forward (of an encdec, one decoder forward); and
    ``enc_k1`` and ``enc_k3``, those of one encdec encoder pass.

    A transformer layer runs 4 attention projections and its FFN: 3 with a
    gated MLP, 2 without (minitron's relu2, seamless's gelu), twice that
    for a MoE layer with shared experts (the routed experts' stack and the
    shared ones', each one launch); then the head.  A Mamba2 layer runs
    in_proj and out_proj, the hybrid's shared block 8 projections at each
    of its L / every invocations (its 8 weights encoded once).  An encdec
    encoder pass is the frontend and 4 + MLP a layer, a decoder forward 4
    self- and 4 cross-attention projections and the MLP a layer, then the
    head.  A tied head is never prequantized, so each forward encodes
    ``embed.T`` (one K3) before its K1; bf16 weights kept as they are
    encode every weight before its K1."""
    mlp = 3 if cfg.glu else 2
    enc, tied = 0, False
    if cfg.family in ("ssm", "hybrid"):
        shared = cfg.family == "hybrid"
        inv = cfg.n_layers // cfg.shared_attn_every if shared else 0
        k1 = 2 * cfg.n_layers + 8 * inv + 1
        build = 2 * cfg.n_layers + 1 + 8 * shared
    elif cfg.family == "encdec":
        enc = 1 + cfg.enc_layers * (4 + mlp)
        k1 = cfg.dec_layers * (8 + mlp) + 1
        build = enc + k1
    else:  # dense, moe, vlm
        ffn = mlp * (2 if cfg.n_shared_experts else 1) if cfg.n_experts else mlp
        k1 = cfg.n_layers * (4 + ffn) + 1
        tied = cfg.tie_embeddings
        build = k1 - tied
    return {"build": build, "k1": k1, "k3": int(tied) if prequantized else k1,
            "enc_k1": enc, "enc_k3": 0 if prequantized else enc}


def run_summary(run) -> dict:
    """A run's record for the JSON file: without its per-forward calls and
    its kept logits."""
    return {k: v for k, v in run.items() if k not in ("calls", "first_decode")}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def attribute_to_spans(events):
    """Attribute the card's work in a ``torch.profiler`` Chrome trace to
    the engine's spans: each kernel, copy and fill goes to the span
    (``user_annotation`` in ``OBSERVE_SPANS``) whose host interval holds
    the CUDA API call that launched it, joined by correlation id.
    Returns (by span name: count, host ms, device ms, K1 and K2 launches;
    the same for work outside every span, with the launches whose call
    was not found; [K1, K2] launched in each decode span, by its start;
    K1 launches outside a prefill, decode or verify span and K2 launches
    outside a decode span)."""
    import bisect

    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") in OBSERVE_SPANS)
    starts = [sp[0] for sp in spans]
    launched_at = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            launched_at[corr] = e["ts"]
    by_span = {}
    for t_start, t_end, name in spans:
        row = by_span.setdefault(name, {"count": 0, "host_ms": 0.0, "device_ms": 0.0,
                                        "k1": 0, "k2": 0})
        row["count"] += 1
        row["host_ms"] += (t_end - t_start) / 1e3
    outside = {"device_ms": 0.0, "k1": 0, "k2": 0, "unmatched": 0}
    per_decode = {}
    misplaced = []
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        name = e.get("name", "")
        k1 = e["cat"] == "kernel" and "plam_matmul" in name
        k2 = e["cat"] == "kernel" and "decode_attention_core" in name and "true>" in name
        t = launched_at.get((e.get("args") or {}).get("correlation"))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        span = spans[i] if i >= 0 and t <= spans[i][1] else None
        row = by_span[span[2]] if span is not None else outside
        row["device_ms"] += e.get("dur", 0) / 1e3
        row["k1"] += k1
        row["k2"] += k2
        if t is None:
            outside["unmatched"] += 1
        where = span[2] if span is not None else None
        if (k1 and where not in ("serve.prefill", "serve.decode", "serve.verify")) or (
                k2 and where != "serve.decode"):
            misplaced.append((name[:60], where))
        if where == "serve.decode":
            c = per_decode.setdefault(span[0], [0, 0])
            c[0] += k1
            c[1] += k2
    return by_span, outside, per_decode, misplaced


class Smoke:
    def __init__(self, args):
        import torch

        self.torch = torch
        self.args = args
        self.dev = torch.device("cuda")
        self.results = {"phases": {}}
        self.kernels = {}  # name -> the entry of the {"kernels": [...]} line
        self.path_launches = {}  # kernel -> launches in the run of its path
        self.clock_mhz = None

    # -- helpers -------------------------------------------------------------

    def gen(self, seed: int):
        g = self.torch.Generator(device=self.dev)
        g.manual_seed(seed)
        return g

    def events_ms(self, fn, reps: int, warmup: int = 2, flush: bool = True,
                  spin: bool = False, spin_cycles: int = SPIN_CYCLES) -> float:
        """Mean ms between CUDA events around fn() over reps calls, each
        after an L2 flush.  The window opens when the card reaches the
        start event, so for a short call it also holds the host time of
        fn()'s wrapper up to its launch.  With spin, a device spin of
        spin_cycles (about 0.1 ms by default) is queued before the start
        event, so that the host has queued fn()'s launches before the card
        gets there: the window is then fn()'s device time alone."""
        torch = self.torch
        for _ in range(warmup):
            if spin:  # the spin's own first launch loads its kernel
                torch.cuda._sleep(SPIN_CYCLES)
            fn()
        scrub = torch.empty(64 << 20, dtype=torch.int32, device=self.dev) if flush else None
        total = 0.0
        for _ in range(reps):
            if scrub is not None:
                scrub.zero_()  # 256 MB: evicts the 50 MB L2
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(spin_cycles)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / reps

    def host_us(self, fn, calls: int = HOST_CALLS) -> float:
        """Host microseconds per call of fn(): `calls` back-to-back calls
        with no sync, queued behind a device spin so that the card never
        holds the host back, divided by `calls`."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(HOST_SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / calls * 1e6

    def timed(self, fn, reps: int):
        """(window, device) ms of fn(): events_ms without and with the spin."""
        return self.events_ms(fn, reps), self.events_ms(fn, reps, spin=True)

    def sdpa(self, q, kc, vc, lens):
        """A call of scaled_dot_product_attention for q [B, H, hd] over kc,
        vc [B, kv, S, hd] with a boolean length mask: the library yardstick
        of K2 and K5 (timed only; the port never calls it)."""
        torch = self.torch
        import torch.nn.functional as F

        h, kv, s = q.shape[1], kc.shape[1], kc.shape[2]
        mask = (torch.arange(s, device=self.dev)[None, :] < lens[:, None])[:, None, None, :]
        qs = q[:, :, None, :]
        try:
            F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask, enable_gqa=True)
            lib_kv, lib_kw = (kc, vc), {"enable_gqa": True}
        except TypeError:  # torch without enable_gqa: expand kv heads first
            lib_kv = (kc.repeat_interleave(h // kv, 1), vc.repeat_interleave(h // kv, 1))
            lib_kw = {}
        return lambda: F.scaled_dot_product_attention(qs, *lib_kv, attn_mask=mask, **lib_kw)

    @staticmethod
    def device_us_by_name(prof, keep=lambda evt: True):
        """Self device µs summed by event name over a torch.profiler
        capture, for the events ``keep`` accepts."""
        by_name = {}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0)
            if us > 0 and keep(evt):
                by_name[evt.key] = by_name.get(evt.key, 0.0) + us
        return by_name

    def int32_ops_per_s(self) -> float:
        return SMS * INT32_LANES_PER_SM * self.clock_mhz * 1e6

    # -- phase 1 -------------------------------------------------------------

    def phase_device(self):
        torch = self.torch
        from repro_torch.kernels import _lib

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
        log(card)
        clk = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60)
        self.clock_mhz = float(clk.stdout.strip().splitlines()[0])
        name = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name!r} "
            f"count {count} max_sm_clock_mhz {self.clock_mhz}")
        t0 = time.perf_counter()
        _lib.library()
        log(f"kernel build: {_lib.build_seconds:.1f} s compiling "
            f"({time.perf_counter() - t0:.1f} s with load)")
        self.results["device"] = {"nvidia_smi": card, "name": name, "count": count,
                                  "max_sm_clock_mhz": self.clock_mhz,
                                  "build_s": _lib.build_seconds}
        self.device_info = {"platform": "gpu", "kind": name, "count": count}

    # -- phase 2 -------------------------------------------------------------

    def phase_kernels(self):
        torch = self.torch
        from repro_torch.kernels.plam_matmul import plam_matmul
        from repro_torch.kernels.posit_codec import (
            posit_decode,
            posit_encode,
            posit_quantize,
        )
        from repro_torch.numerics import P16, PositSpec

        def bits(t):
            return t.view(torch.int32) if t.dtype == torch.float32 else t

        failures = []

        def same(what, got, want):
            ok = got.shape == want.shape and torch.equal(bits(got), bits(want))
            if not ok:
                n_bad = int((bits(got) != bits(want)).sum()) if got.shape == want.shape else -1
                failures.append(f"{what}: {n_bad} lanes differ")
            return ok

        # K3 — decode over all 65,536 patterns, as int32 and as int16, at
        # every spec of K3_PATH_SPECS (Posit<16,1> compiled in), aligned
        # and at an odd element offset
        pats = torch.arange(1 << 16, dtype=torch.int32, device=self.dev)
        p16 = ((pats ^ 0x8000) - 0x8000).to(torch.int16)
        for n, es in K3_PATH_SPECS:
            spec = PositSpec(n, es)
            for p in (pats, p16, pats[1:], p16[1:]):
                same(f"decode {spec} {str(p.dtype)[6:]} [{p.numel()}]", posit_decode(p, spec),
                     posit_decode(p, spec, use_kernel=False))
        # ... and tiled and shuffled to K3_DECODE_BIG_LANES, where each thread
        # of the grid takes more than two chunks (the two-in-flight loop, which
        # every prequantized weight of phase static runs), the same four ways
        g = self.gen(29)
        tiled = p16.repeat(-(-K3_DECODE_BIG_LANES // (1 << 16)))[:K3_DECODE_BIG_LANES]
        tiled = tiled[torch.randperm(tiled.numel(), generator=g, device=self.dev)]
        for n, es in K3_PATH_SPECS:
            spec = PositSpec(n, es)
            for p in (tiled, tiled.to(torch.int32) & 0xFFFF):
                for part in (p, p[1:]):
                    same(f"decode {spec} {str(p.dtype)[6:]} [{part.numel()}]",
                         posit_decode(part, spec), posit_decode(part, spec, use_kernel=False))
        del tiled
        # K3's computed paths at their edges of one lane a thread (each
        # threshold - 1, its value, + 1; aligned and at offset 1): the
        # decode, the encode and the quantize of bf16 and f32
        edges = self.k3_by_lane_max()
        edge = edges["decode"]
        pe = p16.repeat(-(-(edge + 2) // (1 << 16)))
        for size in (edge - 1, edge, edge + 1):
            for off in (0, 1):
                part = slice(off, off + size)
                same(f"decode P16 int16 [{size}] at {off}", posit_decode(pe[part]),
                     posit_decode(pe[part], use_kernel=False))
        edge = edges["quantize"]
        xe = torch.randn((edge + 2,), generator=g, device=self.dev)
        for size in (edge - 1, edge, edge + 1):
            for off in (0, 1):
                part = slice(off, off + size)
                for xt in (xe[part], xe.to(torch.bfloat16)[part]):
                    tag = f"{str(xt.dtype)[6:]} [{size}] at {off}"
                    same(f"encode {tag}", posit_encode(xt, P16, out_dtype=torch.int16),
                         posit_encode(xt, P16, out_dtype=torch.int16, use_kernel=False))
                    # Posit<20,2>: bf16 computes at every size (no table for n > 16)
                    for spec in (P16, PositSpec(20, 2)):
                        same(f"quantize {tag} {spec}", posit_quantize(xt, spec),
                             posit_quantize(xt, spec, use_kernel=False))
        # K3 — encode / quantize over a seeded f32 sweep with the edge cases
        g = self.gen(3)
        expo = torch.randint(-140, 130, (1 << 20,), generator=g, device=self.dev)
        sweep = torch.randn((1 << 20,), generator=g, device=self.dev) * torch.exp2(
            expo.to(torch.float32))
        edges = torch.tensor(
            [0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1e-40, -1e-40, 1e-45,
             -1e-45, 3e38, -3e38, 2.0 ** 60, -(2.0 ** 60), 2.0 ** -60, 1.0, -1.0],
            dtype=torch.float32, device=self.dev)
        sweep = torch.cat([sweep, edges])
        acts = [torch.randn(s, generator=g, device=self.dev) for s in ((4, 4096), (64, 11008))]
        for x in [sweep, *acts]:
            for xt in (x, x.to(torch.bfloat16)):
                tag = f"{tuple(xt.shape)} {xt.dtype}"
                for od in (torch.int32, torch.int16):
                    same(f"encode {tag} -> {od}", posit_encode(xt, P16, out_dtype=od),
                         posit_encode(xt, P16, out_dtype=od, use_kernel=False))
                same(f"quantize {tag}", posit_quantize(xt, P16),
                     posit_quantize(xt, P16, use_kernel=False))
        paths = self.check_encode_paths(same, failures, sweep)
        quant_paths = self.check_quantize_paths(same, failures, sweep)
        k3_ok = not failures
        log(f"K3 posit codec vs plain: {'bit-identical' if k3_ok else failures} (decode over "
            f"all patterns at {K3_PATH_SPECS}, also tiled to {K3_DECODE_BIG_LANES} lanes; the "
            f"computed paths at {edges} +- 1 lanes; encode and quantize over the f32 sweep and the "
            f"activation shapes, f32 and bf16; {paths['calls']} encode and "
            f"{quant_paths['calls']} quantize calls over both paths)")

        # K1 — main-path shapes, int16 B (and int32 B for one shape); at
        # K = N = 4096 every decode-batch M, int16 and int32
        n_before = len(failures)
        cases = [(m, k, n) for m in (4, 64) for k, n in K1_SHAPES]
        cases += [(m, 4096, 4096) for m in K1_DECODE_MS if m != 4]
        for m, k, n in cases:
            a = posit_encode(torch.randn((m, k), generator=g, device=self.dev), P16)
            w = torch.randn((k, n), generator=g, device=self.dev) * k ** -0.5
            b = posit_encode(w, P16, out_dtype=torch.int16)
            same(f"plam_matmul M={m} K={k} N={n} int16",
                 plam_matmul(a, b, P16), plam_matmul(a, b, P16, use_kernel=False))
            if (k, n) == (4096, 4096):
                b32 = posit_encode(w, P16)
                same(f"plam_matmul M={m} K={k} N={n} int32",
                     plam_matmul(a, b32, P16), plam_matmul(a, b32, P16, use_kernel=False))
            torch.cuda.synchronize()
        # K1 — ragged shapes with zero and NaR lanes: the reference's, then
        # the decode path's tile, stage, strip and branch edges; int32 and
        # int16 B
        import numpy as np

        for shape in RAGGED_SHAPES + K1_EDGE_SHAPES + K1_WIDE_EDGE_SHAPES:
            m, k, n = shape
            rng = np.random.default_rng(hash(shape) & 0xFFFF)
            a = rng.integers(0, 1 << 16, (m, k)).astype(np.int32)
            b = rng.integers(0, 1 << 16, (k, n)).astype(np.int32)
            a.flat[:: max(1, a.size // 7)] = P16.nar
            b.flat[:: max(1, b.size // 5)] = 0
            at, bt_ = torch.from_numpy(a).to(self.dev), torch.from_numpy(b).to(self.dev)
            b16 = ((bt_ ^ 0x8000) - 0x8000).to(torch.int16)
            for bb in (bt_, b16):
                same(f"plam_matmul ragged {shape} {str(bb.dtype)[6:]}", plam_matmul(at, bb, P16),
                     plam_matmul(at, bb, P16, use_kernel=False))
            torch.cuda.synchronize()
        prefill_cases = self.check_prefill_edges(same)
        k1_ok = len(failures) == n_before
        log(f"K1 plam_matmul vs plain: {'bit-identical' if k1_ok else failures[n_before:]} "
            f"(with {prefill_cases} prefill-edge cases)")
        fused = self.check_fused_encode(same, failures, sweep)
        k1_ok = k1_ok and fused["ok"]
        grouped = self.check_grouped_k1(same, failures)
        training = self.check_quantize_shapes(same, failures)
        k3_ok = k3_ok and training["ok"]

        k2 = self.check_paged_attention(failures)
        k4_ok = self.check_posit_mul(same, failures)
        k5 = self.check_decode_attention(failures)
        canaries = self.check_canaries(failures)
        self.kernel_err = {"plam_matmul": 0.0 if k1_ok else None,
                           "plam_matmul_grouped": 0.0 if grouped["ok"] else None,
                           "posit_codec": 0.0 if k3_ok else None,
                           "paged_decode_attention": k2["err_f32"],
                           "posit_mul": 0.0 if k4_ok else None,
                           "decode_attention": k5["err_f32"]}
        self.results["kernels"] = {"k1_bit_identical": k1_ok, "k1_fused": fused,
                                   "k1_grouped": grouped, "k3_training_shapes": training,
                                   "k3_bit_identical": k3_ok, "k3_paths": paths,
                                   "k3_quantize_paths": quant_paths,
                                   "k2": k2,
                                   "k4_bit_identical": k4_ok, "k5": k5,
                                   "canaries": canaries,
                                   "failures": failures}
        if failures:
            raise AssertionError("; ".join(failures))

    def check_quantize_shapes(self, same, failures) -> dict:
        """K3's quantize at the training path's weights (bf16 and f32), the
        MoE families' expert stacks and the activations, bit for bit
        against its plain version.  (K1 at the
        Table II shapes is held in phase train, at the shapes its runs
        launch it with.)"""
        torch = self.torch
        from repro_torch.kernels.posit_codec import posit_quantize, quantize_plain
        from repro_torch.numerics import P16

        g = self.gen(17)
        n_before = len(failures)
        weights = K3_QUANT_WEIGHT_SHAPES + K3_QUANT_STACK_SHAPES
        shapes = weights + K3_QUANT_ACT_SHAPES
        for shape in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(shape, generator=g, device=self.dev)
                if shape in weights:
                    x = x * shape[-2] ** -0.5
                x = x.to(dtype)
                same(f"posit_quantize {shape} {str(dtype)[6:]}", posit_quantize(x, P16),
                     quantize_plain(x, P16))
                del x
                torch.cuda.synchronize()
        ok = len(failures) == n_before
        log(f"K3 quantize at the training shapes {shapes}, bf16 and f32: "
            f"{'bit-identical' if ok else 'MISMATCH'}")
        return {"ok": ok, "shapes": shapes}

    def check_encode_paths(self, same, failures, sweep) -> dict:
        """K3's encode against its plain version, bit for bit, on both
        paths: the card's table (built by the computed path) against
        bf16_table_plain at K3_TABLE_SPECS, each built once; all 65,536
        bf16 patterns tiled and shuffled to 2^20 + 13 lanes at
        K3_PATH_SPECS, int16 and int32 out, through the table path (the
        whole) and the computed path (two halves under the threshold), an
        input at element offsets 1, 2 and 4 (head lanes; the output off
        its 16-byte boundary, or on it after the head at 4 -> int32); at
        Posit<16,1>, lanes at the threshold - 1, + 0, + 1 and + 7; the f32
        sweep at an odd offset, at Posit<16,1> (the spec compiled in) and
        Posit<16,2> (given at run time); and seeded bf16 weights at
        K3_WEIGHT_SHAPES (64 blocks of 4 strides at wk/wv; beyond, the
        grid capped at one block an SM, ~43 and ~242 strides on 132 SMs) at
        Posit<16,1>."""
        torch = self.torch
        import numpy as np

        from repro_torch.kernels import _lib
        from repro_torch.kernels.posit_codec import (
            TABLE_MIN_NUMEL,
            bf16_table,
            bf16_table_plain,
            encode_path,
            encode_plain,
            posit_encode,
        )
        from repro_torch.numerics import P16, PositSpec

        _lib.reset_launches()
        for n, es in K3_TABLE_SPECS:
            spec = PositSpec(n, es)
            before = _lib.launches["posit_codec_table"]
            same(f"bf16 table {spec}", bf16_table(spec, self.dev),
                 bf16_table_plain(spec).to(self.dev))
            built_now = _lib.launches["posit_codec_table"] - before
            bf16_table(spec, self.dev)  # cached: no second build
            if built_now > 1 or _lib.launches["posit_codec_table"] != before + built_now:
                failures.append(f"table {spec}: {built_now} builds, then "
                                f"{_lib.launches['posit_codec_table'] - before - built_now} more")
        built = _lib.launches["posit_codec_table"]
        size = TABLE_MIN_NUMEL + 13
        pats = np.tile(np.arange(1 << 16, dtype=np.uint16), size // (1 << 16) + 1)[:size]
        np.random.default_rng(21).shuffle(pats)
        x = torch.from_numpy(pats.view(np.int16).copy()).to(self.dev).view(torch.bfloat16)
        calls, h = 0, size // 2
        for n, es in K3_PATH_SPECS:
            spec = PositSpec(n, es)
            assert encode_path(x.dtype, size, spec) == "table"
            assert encode_path(x.dtype, h + 1, spec) == "computed"
            for od in (torch.int16, torch.int32):
                tag = f"{spec} -> {str(od)[6:]}"
                want = encode_plain(x, spec, od)
                same(f"encode table path, all bf16 patterns {tag}",
                     posit_encode(x, spec, out_dtype=od), want)
                same(f"encode computed path, all bf16 patterns {tag}",
                     torch.cat([posit_encode(x[:h], spec, out_dtype=od),
                                posit_encode(x[h:], spec, out_dtype=od)]), want)
                for off in (1, 2, 4):
                    same(f"encode table path, x[{off}:] {tag}",
                         posit_encode(x[off:], spec, out_dtype=od), want[off:])
                calls += 5
            torch.cuda.synchronize()
        for d in (-1, 0, 1, 7):
            xs = x[:TABLE_MIN_NUMEL + d]
            for od in (torch.int16, torch.int32):
                same(f"encode {xs.numel()} lanes (threshold {d:+d}) -> {str(od)[6:]}",
                     posit_encode(xs, P16, out_dtype=od), encode_plain(xs, P16, od))
                calls += 1
        for spec in (P16, PositSpec(16, 2)):
            for od in (torch.int16, torch.int32):
                same(f"encode f32 sweep[1:] {spec} -> {str(od)[6:]}",
                     posit_encode(sweep[1:], spec, out_dtype=od),
                     encode_plain(sweep[1:], spec, od))
                calls += 1
        torch.cuda.synchronize()
        g = self.gen(17)
        for shape in K3_WEIGHT_SHAPES:
            w = self.k3_input(g, shape, "bf16")
            for od in (torch.int16, torch.int32):
                same(f"encode weight {list(shape)} bf16 -> {str(od)[6:]}",
                     posit_encode(w, P16, out_dtype=od), encode_plain(w, P16, od))
                calls += 1
            del w
            torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"K3 encode paths: {built} table builds for {len(K3_TABLE_SPECS)} specs "
            f"{K3_TABLE_SPECS} (at most one each; Posit<16,1>'s may come from the sweep "
            f"above); {calls} encode calls at {K3_PATH_SPECS} (all bf16 patterns, "
            f"{size} lanes, table and computed path, odd offsets), the threshold "
            f"{TABLE_MIN_NUMEL} -1/+0/+1/+7, the f32 sweep at an odd offset and the "
            f"weights {K3_WEIGHT_SHAPES}")
        return {"table_builds": built, "calls": calls}

    def check_quantize_paths(self, same, failures, sweep) -> dict:
        """K3's quantize against its plain version, bit for bit, on both
        paths: the card's quantize table (built by the computed path)
        against quantize_table_plain at K3_TABLE_SPECS, each built once
        and counted apart (posit_codec_quant_table); all 65,536 bf16
        patterns tiled and shuffled to 2^20 + 13 lanes at K3_PATH_SPECS
        through the table path (the whole, and at element offsets 1, 2 and
        4) and the computed path (two halves under the threshold); at
        Posit<16,1>, lanes at the threshold - 1, + 0, + 1 and + 7; and the
        f32 sweep (computed) at Posit<16,2>, the spec given at run time,
        aligned and at an odd offset (phase kernels takes it at
        Posit<16,1>)."""
        torch = self.torch
        import numpy as np

        from repro_torch.kernels import _lib
        from repro_torch.kernels.posit_codec import (
            TABLE_MIN_NUMEL,
            encode_path,
            posit_quantize,
            quantize_plain,
            quantize_table,
            quantize_table_plain,
        )
        from repro_torch.numerics import P16, PositSpec

        before_all = _lib.launches["posit_codec_quant_table"]
        for n, es in K3_TABLE_SPECS:
            spec = PositSpec(n, es)
            before = _lib.launches["posit_codec_quant_table"]
            same(f"quantize table {spec}", quantize_table(spec, self.dev),
                 quantize_table_plain(spec).to(self.dev))
            built_now = _lib.launches["posit_codec_quant_table"] - before
            quantize_table(spec, self.dev)  # cached: no second build
            if built_now > 1 or _lib.launches["posit_codec_quant_table"] != before + built_now:
                failures.append(f"quantize table {spec}: {built_now} builds, then "
                                f"{_lib.launches['posit_codec_quant_table'] - before - built_now}"
                                " more")
        built = _lib.launches["posit_codec_quant_table"] - before_all
        size = TABLE_MIN_NUMEL + 13
        pats = np.tile(np.arange(1 << 16, dtype=np.uint16), size // (1 << 16) + 1)[:size]
        np.random.default_rng(23).shuffle(pats)
        x = torch.from_numpy(pats.view(np.int16).copy()).to(self.dev).view(torch.bfloat16)
        calls, h = 0, size // 2
        for n, es in K3_PATH_SPECS:
            spec = PositSpec(n, es)
            assert encode_path(x.dtype, size, spec) == "table"
            assert encode_path(x.dtype, h + 1, spec) == "computed"
            want = quantize_plain(x, spec)
            same(f"quantize table path, all bf16 patterns {spec}", posit_quantize(x, spec), want)
            same(f"quantize computed path, all bf16 patterns {spec}",
                 torch.cat([posit_quantize(x[:h], spec), posit_quantize(x[h:], spec)]), want)
            for off in (1, 2, 4):
                same(f"quantize table path, x[{off}:] {spec}", posit_quantize(x[off:], spec),
                     want[off:])
            calls += 6
            torch.cuda.synchronize()
        for d in (-1, 0, 1, 7):
            xs = x[:TABLE_MIN_NUMEL + d]
            same(f"quantize {xs.numel()} lanes (threshold {d:+d})", posit_quantize(xs, P16),
                 quantize_plain(xs, P16))
            calls += 1
        spec = PositSpec(16, 2)
        for part in (sweep, sweep[1:]):
            same(f"quantize f32 sweep [{part.numel()}] {spec}", posit_quantize(part, spec),
                 quantize_plain(part, spec))
            calls += 1
        torch.cuda.synchronize()
        log(f"K3 quantize paths: {built} table builds for {len(K3_TABLE_SPECS)} specs "
            f"(at most one each; Posit<16,1>'s may come from the sweep above); {calls} "
            f"quantize calls at {K3_PATH_SPECS} (all bf16 patterns, {size} lanes, table and "
            f"computed path, offsets 1, 2, 4), the threshold {TABLE_MIN_NUMEL} -1/+0/+1/+7 "
            f"and the f32 sweep at Posit<16,2>")
        return {"table_builds": built, "calls": calls}

    def check_prefill_edges(self, same) -> int:
        """K1's prefill path at K1_PREFILL_EDGE_SHAPES against its plain
        version, bit for bit: A as int32 patterns, f32 and bf16
        activations, B as int16 and int32 patterns.  Operands hold no zero
        or NaR pattern (every full tile runs the fast loop) except in the
        odd cases, which plant both in a middle k-tile of A and of B, and
        zero, inf and NaN there in the activations.  Returns the number of
        kernel calls checked."""
        torch = self.torch
        import numpy as np

        from repro_torch.kernels.plam_matmul import plam_matmul, plam_matmul_float
        from repro_torch.numerics import P16

        cases = 0
        for i, (m, k, n) in enumerate(K1_PREFILL_EDGE_SHAPES):
            rng = np.random.default_rng(1000 + i)
            a = rng.integers(1, 1 << 16, (m, k)).astype(np.int32)
            b = rng.integers(1, 1 << 16, (k, n)).astype(np.int32)
            a[a == P16.nar] = 1
            b[b == P16.nar] = 1
            x = rng.standard_normal((m, k)).astype(np.float32)
            if i % 2:
                t = (k // 32) // 2 * 32  # the first k of a middle tile
                k1, k2, k3 = (min(k - 1, t + d) for d in (1, 2, 5))
                a[m // 2, k3], a[m - 1, k1] = P16.nar, 0
                b[k3, n // 2], b[k2, n - 1] = 0, P16.nar
                x[m // 2, k3], x[m - 1, k1], x[0, k2] = 0.0, np.inf, np.nan
            at, b32 = torch.from_numpy(a).to(self.dev), torch.from_numpy(b).to(self.dev)
            b16 = ((b32 ^ 0x8000) - 0x8000).to(torch.int16)
            xf = torch.from_numpy(x).to(self.dev)
            tag = f"prefill edge ({m}, {k}, {n}){' planted' if i % 2 else ''}"
            for name, fn, xa in [("patterns", plam_matmul, at), ("f32", plam_matmul_float, xf),
                                 ("bf16", plam_matmul_float, xf.to(torch.bfloat16))]:
                want = fn(xa, b32, P16, use_kernel=False)
                for bb in (b16, b32):
                    same(f"{tag} A={name} B={str(bb.dtype)[6:]}", fn(xa, bb, P16), want)
                    cases += 1
            torch.cuda.synchronize()
        return cases

    def check_fused_encode(self, same, failures, sweep) -> dict:
        """K1 over float activations (plam_matmul_float, the route of
        plam_dense) against its plain version, plam_matmul_seqref(encode(x)),
        bit for bit, with int16 and int32 B: all 65,536 bf16 patterns as A
        ([16, 4096], its first 4 rows, and [64, 1024]); the seeded f32
        sweep with its edges (+-0, +-inf, NaN, subnormals, 3e38, 2^+-60)
        and its bf16 rounding, at every M of K1_FUSED_MS (K = N = 4096) and
        at K1_FUSED_KN (M = 4 and 64); and the serve path's shapes, every
        K1_SHAPES (K, N) at each M of K1_SERVE_MS, f32 and bf16, and at
        each M of K1_CHUNK_MS (the chunk and verify paths), bf16, over
        N(0, 1) values with every PLANT-th one a sweep value (the unembed's
        N = 64000 is the one shape that takes the 64-column strip kernel
        over float A).  Each plain result is computed once
        (int32 B) and held against both B dtypes (the CPU tests show the
        plain version gives the same bits for both)."""
        torch = self.torch
        from repro_torch.kernels.plam_matmul import plam_matmul_float
        from repro_torch.kernels.posit_codec import posit_encode
        from repro_torch.numerics import P16

        n_before = len(failures)
        g = self.gen(13)
        weights = {}

        def b_pair(k, n):
            if (k, n) not in weights:
                w = torch.randn((k, n), generator=g, device=self.dev) * k ** -0.5
                weights[(k, n)] = (posit_encode(w, P16),
                                   posit_encode(w, P16, out_dtype=torch.int16))
            return weights[(k, n)]

        def check(tag, x, n):
            b32, b16 = b_pair(x.shape[1], n)
            want = plam_matmul_float(x, b32, P16, use_kernel=False)
            for bb in (b16, b32):
                same(f"plam_matmul_float {tag} {tuple(x.shape)} N={n} {str(bb.dtype)[6:]}",
                     plam_matmul_float(x, bb, P16), want)
            torch.cuda.synchronize()

        pats = (torch.arange(1 << 16, dtype=torch.int32, device=self.dev) - (1 << 15)).to(
            torch.int16).view(torch.bfloat16)
        all16 = pats.view(16, 4096)
        cases = 0
        for x, n in [(all16, 4096), (all16, 512), (all16[:4].contiguous(), 11008),
                     (pats.view(64, 1024), 4100)]:
            check("all bf16 patterns", x, n)
            cases += 1
        # the sweep's edges first, then its seeded values, as [64, 4096]
        rows = torch.cat([sweep[-16:], sweep[:64 * 4096 - 16]]).view(64, 4096)
        for xs in (rows, rows.to(torch.bfloat16)):
            tag = f"sweep {str(xs.dtype)[6:]}"
            for m in K1_FUSED_MS:
                check(tag, xs[:m].contiguous(), 4096)
                cases += 1
            for m in (4, 64):
                for k, n in K1_FUSED_KN:
                    check(tag, xs[:m, :k].contiguous(), n)
                    cases += 1
        m_top = max(K1_SERVE_MS)
        for k in sorted({k for k, _ in K1_SHAPES}):
            acts = torch.randn((m_top, k), generator=g, device=self.dev).view(-1)
            acts[::PLANT] = sweep[: acts[::PLANT].numel()]
            acts[:16] = sweep[-16:]  # the edges
            acts = acts.view(m_top, k)
            for xs in (acts, acts.to(torch.bfloat16)):
                ms = K1_SERVE_MS + (K1_CHUNK_MS if xs.dtype == torch.bfloat16 else ())
                for m in ms:
                    for kk, n in K1_SHAPES:
                        if kk == k:
                            check(f"serve shape {str(xs.dtype)[6:]}", xs[:m].contiguous(), n)
                            cases += 1
            weights.clear()
        ok = len(failures) == n_before
        log(f"K1 over float activations vs plain encode + matmul: "
            f"{'bit-identical' if ok else failures[n_before:]} over {cases} (A, N) cases, "
            f"int16 and int32 B (all 65,536 bf16 patterns; f32 sweep and edges and its bf16 "
            f"rounding at M {list(K1_FUSED_MS)} and (K, N) {K1_FUSED_KN} at M = 4, 64; "
            f"f32 and bf16 at every K1_SHAPES (K, N) at M {list(K1_SERVE_MS)}, bf16 at M "
            f"{list(K1_CHUNK_MS)})")
        return {"ok": ok, "cases": cases}

    def check_grouped_k1(self, same, failures) -> dict:
        """K1 over a stack of experts ([E, M, K] x [E, K, N], one launch),
        bit for bit: against its grouped plain version over the first
        K1_GROUPED_PLAIN_E experts of deepseek's and granite's stacks at
        K1_GROUPED_MS, f32 and bf16 A, int16 and int32 B; against the 2-D
        kernel run expert by expert over all 64 and 32 experts; at E = 1
        against the 2-D call; at E = 3 over K1_GROUPED_RAGGED with zero and
        NaR (zero, inf and NaN in float A) planted, pattern, f32 and bf16 A.
        Then the 2-D kernel at granite's unembed (odd N) against its plain
        version.  Each launch over a stack counts under plam_matmul_grouped."""
        torch = self.torch
        import numpy as np

        from repro_torch.kernels import _lib
        from repro_torch.kernels.plam_matmul import plam_matmul, plam_matmul_float
        from repro_torch.kernels.posit_codec import posit_encode
        from repro_torch.numerics import P16

        n_before = len(failures)
        g = self.gen(17)
        cases = 0

        def stack(e, k, n):
            w = torch.randn((e, k, n), generator=g, device=self.dev) * k ** -0.5
            b32 = posit_encode(w, P16)
            return b32, ((b32 ^ 0x8000) - 0x8000).to(torch.int16)

        def dt(t):
            return str(t.dtype)[6:]

        # 1. the first experts, against the grouped plain version
        for arch, shapes in MOE_SHAPES.items():
            for k, n in shapes:
                b32, b16 = stack(K1_GROUPED_PLAIN_E, k, n)
                for m in K1_GROUPED_MS:
                    x = torch.randn((K1_GROUPED_PLAIN_E, m, k), generator=g, device=self.dev)
                    for xa in (x, x.to(torch.bfloat16)):
                        want = plam_matmul_float(xa, b32, P16, use_kernel=False)
                        for bb in (b16, b32):
                            same(f"grouped K1 {arch} E={K1_GROUPED_PLAIN_E} M={m} K={k} N={n} "
                                 f"A={dt(xa)} B={dt(bb)} vs plain",
                                 plam_matmul_float(xa, bb, P16), want)
                            cases += 1
                    torch.cuda.synchronize()
        # 2. every expert, against the 2-D kernel expert by expert
        for arch, shapes in MOE_SHAPES.items():
            e = MOE_EXPERTS[arch]
            for k, n in shapes:
                b32, b16 = stack(e, k, n)
                for m in K1_GROUPED_MS:
                    x = torch.randn((e, m, k), generator=g, device=self.dev).to(torch.bfloat16)
                    for bb in ((b16, b32) if m == 1 else (b16,)):
                        before = _lib.launches["plam_matmul_grouped"]
                        got = plam_matmul_float(x, bb, P16)
                        if _lib.launches["plam_matmul_grouped"] != before + 1:
                            failures.append(f"grouped K1 {arch}: not one grouped launch")
                        want = torch.stack([plam_matmul_float(x[i], bb[i], P16)
                                            for i in range(e)])
                        same(f"grouped K1 {arch} E={e} M={m} K={k} N={n} B={dt(bb)} vs 2-D",
                             got, want)
                        cases += 1
                del b32, b16
                torch.cuda.synchronize()
        # 3. E = 1 against the 2-D call, and E = 3 at ragged shapes
        for m, k, n in [(4, 2048, 1408), (60, 1408, 2048)]:
            b32, b16 = stack(1, k, n)
            x = torch.randn((1, m, k), generator=g, device=self.dev).to(torch.bfloat16)
            same(f"grouped K1 E=1 M={m} K={k} N={n} vs 2-D", plam_matmul_float(x, b16, P16),
                 plam_matmul_float(x[0], b16[0], P16)[None])
            cases += 1
        for i, (m, k, n) in enumerate(K1_GROUPED_RAGGED):
            rng = np.random.default_rng(2000 + i)
            a = rng.integers(0, 1 << 16, (3, m, k)).astype(np.int32)
            b = rng.integers(0, 1 << 16, (3, k, n)).astype(np.int32)
            a.flat[:: max(1, a.size // 7)] = P16.nar
            b.flat[:: max(1, b.size // 5)] = 0
            x = rng.standard_normal((3, m, k)).astype(np.float32)
            x[1, m // 2, k // 2], x[2, m - 1, 0], x[0, 0, k - 1] = 0.0, np.inf, np.nan
            at, b32 = torch.from_numpy(a).to(self.dev), torch.from_numpy(b).to(self.dev)
            b16 = ((b32 ^ 0x8000) - 0x8000).to(torch.int16)
            xf = torch.from_numpy(x).to(self.dev)
            for name, fn, xa in [("patterns", plam_matmul, at), ("f32", plam_matmul_float, xf),
                                 ("bf16", plam_matmul_float, xf.to(torch.bfloat16))]:
                want = fn(xa, b32, P16, use_kernel=False)
                for bb in (b16, b32):
                    tag = f"grouped K1 ragged E=3 ({m}, {k}, {n}) A={name} B={dt(bb)}"
                    got = fn(xa, bb, P16)
                    same(f"{tag} vs plain", got, want)
                    same(f"{tag} vs 2-D", got, torch.stack([fn(xa[j], bb[j], P16)
                                                            for j in range(3)]))
                    cases += 2
            torch.cuda.synchronize()
        # 4. the 2-D kernel at granite's unembed (odd N)
        k, n = K1_GRANITE_UNEMBED
        b32 = posit_encode(torch.randn((k, n), generator=g, device=self.dev) * k ** -0.5, P16)
        b16 = ((b32 ^ 0x8000) - 0x8000).to(torch.int16)
        for m in K1_GRANITE_UNEMBED_MS:
            x = torch.randn((m, k), generator=g, device=self.dev).to(torch.bfloat16)
            want = plam_matmul_float(x, b32, P16, use_kernel=False)
            for bb in (b16, b32):
                same(f"K1 granite unembed M={m} K={k} N={n} B={dt(bb)}",
                     plam_matmul_float(x, bb, P16), want)
                cases += 1
        torch.cuda.synchronize()
        ok = len(failures) == n_before
        log(f"K1 over a stack of experts: {'bit-identical' if ok else failures[n_before:]} over "
            f"{cases} cases (the first {K1_GROUPED_PLAIN_E} experts of deepseek's and granite's "
            f"stacks {MOE_SHAPES} against the grouped plain version at M "
            f"{list(K1_GROUPED_MS)}, f32 and bf16 A, int16 and int32 B; all "
            f"{list(MOE_EXPERTS.values())} experts against the 2-D kernel expert by expert; "
            f"E = 1; E = 3 at {K1_GROUPED_RAGGED} with zero and NaR planted); the 2-D kernel at "
            f"granite's unembed {K1_GRANITE_UNEMBED} at M {list(K1_GRANITE_UNEMBED_MS)}")
        return {"ok": ok, "cases": cases}

    def paged_case(self, g, lengths, max_blk=None, h=32, kv=4, hd=128, bs=16,
                   q_dtype=None, kv_dtype=None):
        """Seeded K2 inputs: each sequence owns ceil(length / bs) pool blocks
        (at least one) at permuted places in the pool; table rows are padded
        with block 0, a scratch block of random rows, up to max_blk."""
        torch = self.torch
        q_dtype = q_dtype or torch.bfloat16
        kv_dtype = kv_dtype or torch.bfloat16
        need = [max(1, -(-n // bs)) for n in lengths]
        max_blk = max_blk or max(need)
        nb = 1 + sum(need) + 3
        perm = torch.randperm(nb - 1, generator=g, device=self.dev) + 1
        tables = torch.zeros((len(lengths), max_blk), dtype=torch.int32, device=self.dev)
        pos = 0
        for i, c in enumerate(need):
            tables[i, :c] = perm[pos:pos + c]
            pos += c
        q = torch.randn((len(lengths), h, hd), generator=g, device=self.dev).to(q_dtype)
        kp = torch.randn((nb, bs, kv, hd), generator=g, device=self.dev).to(kv_dtype)
        vp = torch.randn((nb, bs, kv, hd), generator=g, device=self.dev).to(kv_dtype)
        lens = torch.tensor(lengths, dtype=torch.int32, device=self.dev)
        return q, kp, vp, tables, lens

    def check_paged_attention(self, failures) -> dict:
        """K2 against its plain version: at f32 (the plain version run on the
        same values cast to f32) within K2_TOL_F32, and where q or the pool
        is bf16 against the plain version in the same dtypes within
        K2_TOL_BF16.  Shapes: ragged serving lengths; the long paged
        context; the length edges (LENGTH_EDGES, the split plan's edge +- 1,
        the full cache) at long and at serving capacity, in all four dtype
        pairs; other group sizes and head dims."""
        torch = self.torch
        from repro_torch.kernels.decode_attention import (
            paged_decode_attention_kernel,
            paged_decode_attention_ref,
            card_sms,
            split_plan,
        )

        g = self.gen(4)
        bf, f32 = torch.bfloat16, torch.float32
        pairs = [(bf, bf), (f32, bf), (f32, f32), (bf, f32)]
        cap = K2_LONG_MAX_BLK * 16
        sms = card_sms(torch.cuda.current_device())
        sk = split_plan(len(LENGTH_EDGES) + 5, 4, cap, sms).split_keys
        edges = LENGTH_EDGES + [sk - 1, sk, sk + 1, cap - 1, cap]
        cases = [("ragged", dict(lengths=[1, 15, 16, 77]), pairs[:1]),
                 ("long", dict(lengths=K2_LONG_LENGTHS, max_blk=K2_LONG_MAX_BLK), pairs[:1]),
                 (f"edges (split {sk})", dict(lengths=edges, max_blk=K2_LONG_MAX_BLK), pairs),
                 ("serving edges", dict(lengths=[0, 1, 15, 16, 17, 79, 80], max_blk=5), pairs)]
        # ... and deepseek-moe-16b's (16 kv heads of 16, group 1) and
        # granite-moe-1b-a400m's (16 over 8, hd 64)
        for h, kv, hd in [(48, 4, 128), (16, 1, 256), (8, 8, 64), (8, 4, 32), (4, 2, 16),
                          (16, 16, 128), (16, 8, 64)]:
            cases.append((f"h={h} kv={kv} hd={hd}",
                          dict(lengths=[0, 5, 300, 700], max_blk=48, h=h, kv=kv, hd=hd),
                          [(bf, bf), (f32, f32)]))
        rows, worst32, worst16, worst_tight = [], 0.0, 0.0, {"f32": 0.0, "bf16": -1.0}
        for name, kw, dts in cases:
            for qd, kd in dts:
                q, kp, vp, tables, lens = self.paged_case(g, q_dtype=qd, kv_dtype=kd, **kw)
                got = paged_decode_attention_kernel(q, kp, vp, tables, lens).float()
                ref32 = paged_decode_attention_ref(q.float(), kp.float(), vp.float(), tables,
                                                   lens)
                err32 = float((got - ref32).abs().max())
                err16 = None
                if bf in (qd, kd):
                    ref = paged_decode_attention_ref(q, kp, vp, tables, lens).float()
                    err16 = float((got - ref).abs().max())
                # K5's gates: f32 out within K5_TOL_F32, bf16 out within
                # K5_BF16_REL |out| + K5_BF16_ORDER of the plain f32 result
                if qd == f32:
                    tight, tight_ok = err32, err32 <= K5_TOL_F32
                else:
                    tight = float(((got - ref32).abs() - K5_BF16_REL * ref32.abs()).max())
                    tight_ok = tight <= K5_BF16_ORDER
                finite = bool(torch.isfinite(got).all())
                torch.cuda.synchronize()
                tag = f"{name} q {str(qd)[6:]} kv {str(kd)[6:]}"
                ok = (finite and tight_ok and err32 <= K2_TOL_F32
                      and (err16 is None or err16 <= K2_TOL_BF16))
                if not ok:
                    failures.append(f"paged attention {tag}: err_f32 {err32} err_bf16 {err16} "
                                    f"K5 gate {tight} finite {finite}")
                worst32 = max(worst32, err32)
                worst16 = max(worst16, err16 or 0.0)
                out_dt = "f32" if qd == f32 else "bf16"
                worst_tight[out_dt] = max(worst_tight[out_dt], tight)
                rows.append({"case": tag, "lengths": kw["lengths"], "err_f32": err32,
                             "err_bf16": err16, "k5_gate": tight, "finite": finite})
        log(f"K2 paged_decode_attention over {len(rows)} cases (ragged, long "
            f"{K2_LONG_LENGTHS}, length edges {edges} and [0, 1, 15, 16, 17, 79, 80], groups "
            f"1-16, hd 16-256; four dtype pairs): max_abs_err vs plain f32 {worst32:.3e} (tol "
            f"{K2_TOL_F32}), vs plain bf16 {worst16:.3e} (tol {K2_TOL_BF16}); K5's gates: f32 "
            f"out {worst_tight['f32']:.3e} (tol {K5_TOL_F32}), bf16 out largest |err| - 2^-8 "
            f"|out| {worst_tight['bf16']:.3e} (tol {K5_BF16_ORDER})")
        for r in rows:
            log(f"  {r['case']}: f32 {r['err_f32']:.3e}" + (
                f", bf16 {r['err_bf16']:.3e}" if r["err_bf16"] is not None else "")
                + f", K5 gate {r['k5_gate']:.3e}")
        return {"err_f32": worst32, "err_bf16": worst16, "k5_gate_f32_out": worst_tight["f32"],
                "k5_gate_bf16_out": worst_tight["bf16"], "cases": rows}

    def check_posit_mul(self, same, failures) -> bool:
        """K4 against its plain version, raw int32 words: Posit<10,1> over
        every pattern pair, 2^20 seeded pairs at Posit<16,1>, <16,2> and
        <32,2> (plam_mul only: the exact product needs n <= 16), and one
        ragged length with zero and NaR lanes."""
        torch = self.torch
        import numpy as np

        from repro_torch.conformance.vectors import pair_grid
        from repro_torch.kernels.posit_codec import (
            exact_mul_elementwise,
            plam_mul_elementwise,
        )
        from repro_torch.numerics import PositSpec

        n_before = len(failures)
        cases = [("Posit<10,1> all 1048576 pairs", PositSpec(10, 1), *pair_grid(10))]
        rng = np.random.default_rng(12)
        for n, es in [(16, 1), (16, 2), (32, 2)]:
            pa, pb = (rng.integers(0, 1 << n, 1 << 20).astype(np.uint32).view(np.int32)
                      for _ in range(2))
            cases.append((f"Posit<{n},{es}> 2^20 seeded pairs", PositSpec(n, es), pa, pb))
        pa, pb = (rng.integers(0, 1 << 16, 1000).astype(np.int32) for _ in range(2))
        pa[::37], pb[::41] = 0, 1 << 15
        cases.append(("Posit<16,1> 1000 ragged lanes", PositSpec(16, 1), pa, pb))
        for tag, spec, pa, pb in cases:
            a = torch.from_numpy(np.ascontiguousarray(pa)).to(self.dev)
            b = torch.from_numpy(np.ascontiguousarray(pb)).to(self.dev)
            fns = [plam_mul_elementwise] + ([exact_mul_elementwise] if spec.n <= 16 else [])
            for fn in fns:
                same(f"{fn.__name__} {tag}", fn(a, b, spec), fn(a, b, spec, use_kernel=False))
            torch.cuda.synchronize()
        ok = len(failures) == n_before
        log(f"K4 posit_mul vs plain: {'bit-identical' if ok else failures[n_before:]} "
            f"over {', '.join(c[0] for c in cases)}")
        return ok

    def check_decode_attention(self, failures) -> dict:
        """K5 against its plain version at yi-6b's widths (f32 and bf16) and
        at the reference's two small shapes (f32); then the public entry
        point run once per yi-6b layer, counted as K5's path."""
        torch = self.torch
        from repro_torch.kernels import _lib
        from repro_torch.kernels.decode_attention import card_sms, decode_attention, split_plan

        g = self.gen(9)
        sh = K5_SHAPE
        q = torch.randn((sh["b"], sh["h"], sh["hd"]), generator=g, device=self.dev)
        k = torch.randn((sh["b"], sh["s"], sh["kv"], sh["hd"]), generator=g, device=self.dev)
        v = torch.randn((sh["b"], sh["s"], sh["kv"], sh["hd"]), generator=g, device=self.dev)
        lens = torch.tensor(K5_LENGTHS, dtype=torch.int32, device=self.dev)

        def err(q, k, v, lens, **kw):
            got = decode_attention(q, k, v, lens, **kw)
            want = decode_attention(q, k, v, lens, use_kernel=False)
            return float((got.float() - want.float()).abs().max()), got

        err32, _ = err(q, k, v, lens)
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        err16, out16 = err(qb, kb, vb, lens)
        # the plain version's f32 result on the same bf16 inputs (it casts
        # them to f32 first; its bf16 output is this, rounded)
        exact = decode_attention(qb.float(), kb.float(), vb.float(), lens, use_kernel=False)
        excess16 = float(((out16.float() - exact).abs() - K5_BF16_REL * exact.abs()).max())
        small = []
        for b, s, h, kvh, hd, blk in K5_SMALL_SHAPES:
            qs = torch.randn((b, h, hd), generator=g, device=self.dev)
            ks = torch.randn((b, s, kvh, hd), generator=g, device=self.dev)
            vs = torch.randn((b, s, kvh, hd), generator=g, device=self.dev)
            ls = torch.randint(1, s + 1, (b,), generator=g, device=self.dev).to(torch.int32)
            small.append(err(qs, ks, vs, ls, blk=blk)[0])
        # the length edges at yi-6b's widths, the split plan's edge +- 1
        # and the full cache
        s_len = sh["s"]
        sk = split_plan(len(LENGTH_EDGES) + 5, sh["kv"], s_len,
                        card_sms(torch.cuda.current_device())).split_keys
        edges = LENGTH_EDGES + [sk - 1, sk, sk + 1, s_len - 1, s_len]
        qe = torch.randn((len(edges), sh["h"], sh["hd"]), generator=g, device=self.dev)
        ke = torch.randn((len(edges), s_len, sh["kv"], sh["hd"]), generator=g, device=self.dev)
        ve = torch.randn((len(edges), s_len, sh["kv"], sh["hd"]), generator=g, device=self.dev)
        le = torch.tensor(edges, dtype=torch.int32, device=self.dev)
        err_edges, _ = err(qe, ke, ve, le)
        qeb, keb, veb = (t.to(torch.bfloat16) for t in (qe, ke, ve))
        out_e16 = decode_attention(qeb, keb, veb, le)
        exact_e = decode_attention(qeb.float(), keb.float(), veb.float(), le, use_kernel=False)
        excess_edges = float(((out_e16.float() - exact_e).abs()
                              - K5_BF16_REL * exact_e.abs()).max())
        torch.cuda.synchronize()
        errs_f32 = [err32, *small, err_edges]
        excess16 = max(excess16, excess_edges)
        ok = (max(errs_f32) <= K5_TOL_F32 and excess16 <= K5_BF16_ORDER
              and bool(torch.isfinite(out16).all()) and bool(torch.isfinite(out_e16).all()))
        if not ok:
            failures.append(f"decode_attention: err_f32 {errs_f32} bf16 excess {excess16}")
        log(f"K5 decode_attention B=4 H=32 kv=4 hd=128 S=4096 lens={K5_LENGTHS}: max_abs_err "
            f"vs plain f32 {err32:.3e}, small shapes {small[0]:.3e} {small[1]:.3e}, length "
            f"edges {edges} {err_edges:.3e} (tol {K5_TOL_F32}); bf16: max_abs_err vs plain "
            f"bf16 {err16:.3e} (max |out| {float(exact.abs().max()):.3e}), largest |err| - "
            f"2^-8 |out| vs the plain f32 result {excess16:.3e} (edges {excess_edges:.3e}; "
            f"tol {K5_BF16_ORDER})")

        # K5's path: the public entry point, once per yi-6b layer, bf16
        layers = 32
        _lib.reset_launches()
        outs = [decode_attention(qb, kb, vb, lens) for _ in range(layers)]
        torch.cuda.synchronize()
        launched = _lib.launches["decode_attention"]
        self.path_launches["decode_attention"] = launched
        steady = all(torch.equal(o, out16) for o in outs)
        log(f"K5 public entry, {layers} calls at yi-6b width: {launched} launches, "
            f"outputs {'identical' if steady else 'DIFFER'} across calls")
        if launched != layers or not steady:
            failures.append(f"decode_attention path: {launched} launches, steady {steady}")
        return {"err_f32": max(errs_f32), "err_f32_yi": err32, "err_f32_small": small,
                "err_f32_edges": err_edges, "edges": edges, "err_bf16": err16, "bf16_excess": excess16, "path_launches": launched}

    def check_canaries(self, failures, seed: int = 11, cases: int = CANARY_CASES) -> dict:
        """K2 and K5 on seeded random shapes (batch 1-5, 1-8 kv heads, 1-16 q
        heads per kv head, every head dim compiled in, every dtype pair,
        pool blocks of 1-32 keys, capacities up to ~1200 keys, lengths from
        0 to past the capacity, and for K5 a random split size or the
        plan's), with NaN in every element the kernel must not read: pool
        blocks that no table names, table entries past a sequence's live
        blocks, keys at or past a sequence's length, and a guard row on
        either side of q, the pools and the cache.  Each result must be
        finite, within K5's gates of the plain version run on copies with
        those NaNs zeroed, and bitwise the same on a second call (which
        finds the split counters back at 0).  A read of a masked or
        out-of-range row shows as NaN; a wild address, as a CUDA error."""
        torch = self.torch
        import numpy as np

        from repro_torch.kernels.decode_attention import (
            HEAD_DIMS,
            card_sms,
            decode_attention_kernel,
            decode_attention_ref,
            paged_decode_attention_kernel,
            paged_decode_attention_ref,
            split_plan,
        )

        rng = np.random.default_rng(seed)
        g = self.gen(seed)
        bf, f32 = torch.bfloat16, torch.float32
        pairs = [(bf, bf), (f32, bf), (f32, f32), (bf, f32)]
        sms = card_sms(torch.cuda.current_device())
        nan = float("nan")

        def guarded(x):
            """x's values in a tensor with a NaN row before and after it."""
            buf = torch.full((x.shape[0] + 2, *x.shape[1:]), nan, dtype=x.dtype,
                             device=self.dev)
            buf[1:-1] = x
            return buf[1:-1]

        def shape():
            kv = int(rng.choice([1, 2, 4, 8]))
            return (int(rng.integers(1, 6)), kv * int(rng.integers(1, 17)), kv,
                    int(rng.choice(HEAD_DIMS)))

        def lengths_for(b, cap):
            lens = rng.integers(0, cap + 4, b)
            pick = rng.random(b)
            lens[pick < 0.15] = 0
            lens[(pick >= 0.15) & (pick < 0.3)] = cap
            return lens

        bad, worst = [], {"f32": 0.0, "bf16": -1.0}
        max_splits = 0

        def judge(tag, kernel, ref32, out_dtype):
            got = kernel().float()
            again = kernel().float()
            finite = bool(torch.isfinite(got).all())
            if out_dtype == f32:
                gate, key, tol = float((got - ref32).abs().max()), "f32", K5_TOL_F32
            else:
                gate = float(((got - ref32).abs() - K5_BF16_REL * ref32.abs()).max())
                key, tol = "bf16", K5_BF16_ORDER
            torch.cuda.synchronize()
            same = torch.equal(got, again)
            worst[key] = max(worst[key], gate) if finite else worst[key]
            if not (finite and same and gate <= tol):
                bad.append(f"{tag}: finite {finite}, repeatable {same}, K5 gate {gate:.3e}")

        for i in range(cases):
            # K2: the pool holds [NaN block, finite pad block, owned blocks
            # in permuted order, NaN block]
            b, h, kv, hd = shape()
            bs = int(rng.choice([1, 2, 4, 8, 16, 32]))
            max_blk = int(rng.integers(1, 1200 // bs + 1))
            cap = max_blk * bs
            lens = lengths_for(b, cap)
            qd, kd = pairs[int(rng.integers(4))]
            need = [max_blk if n == 0 else -(-min(int(n), cap) // bs) for n in lens]
            nb = 2 + sum(need) + 1
            kp = torch.randn((nb, bs, kv, hd), generator=g, device=self.dev).to(kd)
            vp = torch.randn((nb, bs, kv, hd), generator=g, device=self.dev).to(kd)
            kp[0], vp[0], kp[-1], vp[-1] = nan, nan, nan, nan
            perm = torch.randperm(nb - 3, generator=g, device=self.dev) + 2
            tables = torch.zeros((b, max_blk), dtype=torch.int32, device=self.dev)
            pos = 0
            for j, (n, c) in enumerate(zip(lens, need)):
                tables[j, :c] = perm[pos:pos + c]
                if 0 < n < cap and n % bs:  # the rows past the length in its last block
                    kp[perm[pos + c - 1], n % bs:] = nan
                    vp[perm[pos + c - 1], n % bs:] = nan
                pos += c
            q = torch.randn((b, h, hd), generator=g, device=self.dev).to(qd)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=self.dev)
            ref32 = paged_decode_attention_ref(q.float(), kp.float().nan_to_num(0.0),
                                               vp.float().nan_to_num(0.0), tables, lens_t)
            qg, kg, vg = guarded(q), guarded(kp), guarded(vp)
            max_splits = max(max_splits, split_plan(b, kv, cap, sms).n_splits)
            judge(f"K2 case {i} B={b} H={h} kv={kv} hd={hd} bs={bs} max_blk={max_blk} "
                  f"q {str(qd)[6:]} kv {str(kd)[6:]} lens {lens.tolist()}",
                  lambda: paged_decode_attention_kernel(qg, kg, vg, tables, lens_t), ref32, qd)
            del kp, vp, kg, vg

            # K5: keys at or past each length NaN
            b, h, kv, hd = shape()
            s_len = int(rng.integers(1, 1201))
            lens = lengths_for(b, s_len)
            dt = (f32, bf)[int(rng.integers(2))]
            blk = None if rng.random() < 0.3 else int(rng.integers(1, s_len + 1))
            k = torch.randn((b, s_len, kv, hd), generator=g, device=self.dev).to(dt)
            v = torch.randn((b, s_len, kv, hd), generator=g, device=self.dev).to(dt)
            for j, n in enumerate(lens):
                if 0 < n < s_len:
                    k[j, n:], v[j, n:] = nan, nan
            q = torch.randn((b, h, hd), generator=g, device=self.dev).to(dt)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=self.dev)
            ref32 = decode_attention_ref(q.float(), k.float().nan_to_num(0.0),
                                         v.float().nan_to_num(0.0), lens_t)
            qg, kg, vg = guarded(q), guarded(k), guarded(v)
            max_splits = max(max_splits, split_plan(b, kv, s_len, sms, blk).n_splits)
            judge(f"K5 case {i} B={b} H={h} kv={kv} hd={hd} S={s_len} blk={blk} "
                  f"{str(dt)[6:]} lens {lens.tolist()}",
                  lambda: decode_attention_kernel(qg, kg, vg, lens_t, blk=blk), ref32, dt)
            del k, v, kg, vg
        failures.extend(f"canaries {m}" for m in bad)
        log(f"K2, K5 canaries: {cases} seeded random shapes each (seed {seed}; up to "
            f"{max_splits} splits), NaN in every element they must not read: "
            f"{len(bad)} failed; K5's gates: f32 out {worst['f32']:.3e} (tol {K5_TOL_F32}), "
            f"bf16 out {worst['bf16']:.3e} (tol {K5_BF16_ORDER})")
        for m in bad[:10]:
            log(f"  {m}")
        return {"seed": seed, "cases": cases, "failed": bad, "max_splits": max_splits,
                "k5_gate_f32_out": worst["f32"], "k5_gate_bf16_out": worst["bf16"]}

    # -- phase 3 -------------------------------------------------------------

    def phase_conformance(self):
        """The conformance path at its real size through its CLI, in-process,
        on the default device (CUDA): all 15 committed vector files, then the
        seeded fuzz over the six default specs."""
        import contextlib
        import io

        from repro_torch.conformance import default_impls
        from repro_torch.conformance.__main__ import main as conformance_main
        from repro_torch.kernels import _lib
        from repro_torch.numerics import P16

        oracles = sorted(default_impls(P16))
        log(f"conformance oracles on the default device: {oracles}")
        if "cuda" not in oracles:
            raise AssertionError("the default device did not register the cuda oracle")

        def run(argv):
            buf = io.StringIO()
            _lib.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = conformance_main(argv)
            self.torch.cuda.synchronize()
            return rc, buf.getvalue(), time.perf_counter() - t0, dict(_lib.launches)

        rc_c, out_c, s_c, n_c = run(["check"])
        log(f"conformance check: rc {rc_c} in {s_c:.1f} s, launches K3 {n_c['posit_codec']} "
            f"K4 {n_c['posit_mul']}: {out_c.strip().splitlines()[-1] if out_c.strip() else ''}")
        if rc_c != 0:
            log(out_c)
        rc_f, out_f, s_f, n_f = run(["fuzz", "--seed", "0", "--count", "2048"])
        summary = next((ln for ln in out_f.splitlines() if ln.startswith("conformance fuzz:")),
                       "")
        m = re.match(r"conformance fuzz: (\d+) comparisons, (\d+) mismatches, "
                     r"(\d+) property failures", summary)
        checked, mism, props = (int(x) for x in m.groups()) if m else (0, -1, -1)
        indep = re.search(r"comparisons of independent oracles: (\d+)", out_f)
        independent = int(indep.group(1)) if indep else 0
        log(f"conformance fuzz --seed 0 --count 2048: rc {rc_f} in {s_f:.1f} s, {checked} "
            f"comparisons ({independent} of independent oracles, kernel_plain left out), "
            f"{mism} mismatches, {props} property failures, launches K3 "
            f"{n_f['posit_codec']} K4 {n_f['posit_mul']}")
        if rc_f != 0:
            log(out_f)
        launches = {k: n_c[k] + n_f[k] for k in ("posit_codec", "posit_mul")}
        self.path_launches["posit_mul"] = launches["posit_mul"]
        # K3's paths: this one and the engine build's weight encodes (serve)
        self.path_launches["posit_codec"] = (self.path_launches.get("posit_codec", 0)
                                             + launches["posit_codec"])
        self.results["conformance"] = {
            "oracles": oracles, "check_rc": rc_c, "check_s": s_c, "check_launches": n_c,
            "fuzz_rc": rc_f, "fuzz_s": s_f, "fuzz_launches": n_f, "comparisons": checked,
            "independent_comparisons": independent,
            "mismatches": mism, "property_failures": props, "fuzz_output": out_f}
        if rc_c != 0 or rc_f != 0 or mism != 0 or props != 0 or checked == 0:
            raise AssertionError(f"conformance: check rc {rc_c}, fuzz rc {rc_f}, "
                                 f"{mism} mismatches, {props} property failures")
        if min(launches.values()) == 0:
            raise AssertionError(f"the cuda oracle launched no kernel: {launches}")

    # -- phase 4 -------------------------------------------------------------

    def yi_cfg(self, n_layers):
        from repro_torch.configs import get_config

        cfg = get_config("yi-6b")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        return cfg.with_numerics("default=plam_sim:16:1")

    def phase_serve(self):
        torch = self.torch
        import numpy as np

        from repro_torch.kernels import _lib
        from repro_torch.serving import ServeOptions, build_engine

        layers = self.args.layers
        cfg = self.yi_cfg(layers)
        opts = ServeOptions(max_new_tokens=16, block_size=16, max_slots=4, num_blocks=64,
                            max_seq_len=128, prequantize=True)
        log(f"serve: yi-6b d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv} hd {cfg.hd} "
            f"d_ff {cfg.d_ff} vocab {cfg.vocab} layers {cfg.n_layers} "
            f"param/act {cfg.param_dtype}/{cfg.act_dtype} policy default=plam_sim:16:1 "
            f"prequantized int16")
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        t0 = time.perf_counter()
        eng = build_engine(cfg, opts, init_seed=0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_encodes = _lib.launches["posit_codec"]
        build_tables = _lib.launches["posit_codec_table"]
        n_int16 = sum(p.numel() for p in eng.model.parameters() if p.dtype == torch.int16)
        log(f"engine build {build_s:.1f} s: {build_encodes} weight encodes (K3; "
            f"{build_tables} table builds), {n_int16 / 1e9:.3f} G int16 weights, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        per_forward = launch_counts(cfg)
        if build_encodes != per_forward["build"]:
            raise AssertionError(f"expected {per_forward['build']} weight encodes, got "
                                 f"{build_encodes}")
        self.path_launches["posit_codec"] = self.path_launches.get("posit_codec", 0) + build_encodes

        g = torch.Generator().manual_seed(7)
        lens = torch.randint(32, 65, (4,), generator=g).tolist()
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist() for n in lens]
        self.serve_prompts = prompts
        _lib.reset_launches()  # the main path's run starts here
        t0 = time.perf_counter()
        handles = [eng.submit(p, arrival_step=i, **opts.submit_kwargs())
                   for i, p in enumerate(prompts)]
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_lib.launches)
        for name in ("plam_matmul", "paged_decode_attention"):
            self.path_launches[name] = counts[name]
        st = eng.stats
        forwards = st.prefills + st.decode_steps
        decode_tokens = st.generated_tokens - st.prefills
        log(f"served {len(done)} requests (prompt lens {lens}) in {st.steps} steps, "
            f"{wall:.2f} s wall: prefill {st.prefill_s:.2f} s over {st.prefills} prefills, "
            f"decode {st.decode_s:.2f} s over {st.decode_steps} steps "
            f"({decode_tokens / st.decode_s:.2f} decode tok/s), "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"launches: {counts} (forwards {forwards}, decode steps {st.decode_steps})")
        # one K1 launch a projection, the activations encoded inside it
        expect = {"plam_matmul": per_forward["k1"] * forwards,
                  "posit_codec": per_forward["k3"] * forwards,
                  "paged_decode_attention": layers * st.decode_steps}
        bad = {k: (counts[k], v) for k, v in expect.items() if counts[k] != v}
        outs = [done[h.rid] for h in handles]
        valid = all(len(o) == 16 and all(0 <= t < cfg.vocab for t in o) for o in outs)
        for rid in [h.rid for h in handles]:
            log(f"  req {rid}: {done[rid]}")
        # the counted run's step latencies and seconds, before the profile
        # adds steps and prefills
        run_steps = list(st.step_latency_s)
        counted = {"steps": st.steps, "prefills": st.prefills,
                   "decode_steps": st.decode_steps, "prefill_s": st.prefill_s,
                   "decode_s": st.decode_s}
        log(f"step latency over the {len(run_steps)} steps: p50 "
            f"{np.quantile(run_steps, 0.5) * 1e3:.1f} ms, p95 "
            f"{np.quantile(run_steps, 0.95) * 1e3:.1f} ms, first {run_steps[0] * 1e3:.1f} ms")
        profile, step_launches = self.profile_decode(eng, prompts)
        step_expect = {"plam_matmul": per_forward["k1"], "posit_codec": per_forward["k3"],
                       "paged_decode_attention": layers}
        for k, v in step_expect.items():
            if step_launches[k] != v:
                bad[f"{k} in one decode step"] = (step_launches[k], v)
        self.results["serve"] = {
            "layers": layers, "prompt_lens": lens, **counted, "wall_s": wall,
            "decode_tok_per_s": decode_tokens / counted["decode_s"],
            "step_p50_s": st.latency_p50(), "step_p95_s": st.latency_p95(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "engine_build_s": build_s, "launches": counts, "expected": expect,
            "decode_step_launches": step_launches, "run_step_latency_s": run_steps,
            "run_step_p50_s": float(np.quantile(run_steps, 0.5)),
            "run_step_p95_s": float(np.quantile(run_steps, 0.95)),
            "outputs": outs, "decode_profile": profile}
        del eng, handles  # a handle holds its engine
        torch.cuda.empty_cache()
        if bad:
            raise AssertionError(f"launch counts (got, expected): {bad}")
        if not valid:
            raise AssertionError("a request did not return 16 valid tokens")
        self.serve_unquantized(cfg, opts, prompts, outs, build_tables)

    def serve_unquantized(self, cfg, opts, prompts, want, build_tables):
        """The same requests on an engine that keeps its bf16 weights
        (prequantize=False, ServeOptions' default): each forward encodes
        every weight (K3, bf16 -> int16 on the table path) before its K1
        launch.  Gates: no launch at build; 7L+1 K3 and 7L+1 K1 launches a
        forward and L K2 a decode step; no table build in the run, and at
        most one over the phase (the prequantized build's, or phase
        kernels', is reused); the prequantized run's greedy tokens."""
        torch = self.torch
        import numpy as np

        from repro_torch.kernels import _lib
        from repro_torch.serving import build_engine

        layers = cfg.n_layers
        opts = dataclasses.replace(opts, prequantize=False)
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        t0 = time.perf_counter()
        eng = build_engine(cfg, opts, init_seed=0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        at_build = {k: v for k, v in _lib.launches.items() if v}
        _lib.reset_launches()  # the path's run starts here
        t0 = time.perf_counter()
        handles = [eng.submit(p, arrival_step=i, **opts.submit_kwargs())
                   for i, p in enumerate(prompts)]
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_lib.launches)
        self.path_launches["posit_codec"] = (self.path_launches.get("posit_codec", 0)
                                             + counts["posit_codec"])
        st = eng.stats
        forwards = st.prefills + st.decode_steps
        decode_tokens = st.generated_tokens - st.prefills
        per_forward = launch_counts(cfg, prequantized=False)["k1"]
        expect = {"plam_matmul": per_forward * forwards, "posit_codec": per_forward * forwards,
                  "paged_decode_attention": layers * st.decode_steps, "posit_codec_table": 0}
        bad = {k: (counts[k], v) for k, v in expect.items() if counts[k] != v}
        if at_build:
            bad["launches at build"] = (at_build, {})
        if build_tables > 1:
            bad["table builds over the phase"] = (build_tables, 1)
        outs = [done[h.rid] for h in handles]
        run_steps = list(st.step_latency_s)
        # the counted run's, before the profile adds steps
        counted = {"prefills": st.prefills, "decode_steps": st.decode_steps,
                   "prefill_s": st.prefill_s, "decode_s": st.decode_s}
        decode_s = st.decode_s
        log(f"unquantized bf16 weights (prequantize=False): build {build_s:.1f} s, served "
            f"{len(done)} requests in {st.steps} steps, {wall:.2f} s wall: prefill "
            f"{st.prefill_s:.2f} s over {st.prefills} prefills, decode {decode_s:.2f} s over "
            f"{st.decode_steps} steps ({decode_tokens / decode_s:.2f} decode tok/s), step p50 "
            f"{np.quantile(run_steps, 0.5) * 1e3:.1f} ms, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"launches: {counts} (forwards {forwards}, decode steps {st.decode_steps})")
        log(f"greedy tokens {'equal to' if outs == want else 'DIFFER from'} the prequantized "
            f"run's")
        profile, step_launches = self.profile_decode(eng, prompts)
        step_expect = {"plam_matmul": per_forward, "posit_codec": per_forward,
                       "paged_decode_attention": layers, "posit_codec_table": 0}
        for k, v in step_expect.items():
            if step_launches[k] != v:
                bad[f"{k} in one decode step"] = (step_launches[k], v)
        self.results["serve"]["unquantized"] = {
            "engine_build_s": build_s, "wall_s": wall, **counted,
            "decode_tok_per_s": decode_tokens / decode_s,
            "run_step_p50_s": float(np.quantile(run_steps, 0.5)),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts,
            "expected": expect, "decode_step_launches": step_launches, "outputs": outs,
            "tokens_equal": outs == want, "decode_profile": profile}
        del eng, handles
        torch.cuda.empty_cache()
        if bad:
            raise AssertionError(f"unquantized serve, launch counts (got, expected): {bad}")
        if outs != want:
            raise AssertionError("unquantized serve: greedy tokens differ from the "
                                 "prequantized run's")

    def profile_decode(self, eng, prompts):
        """Launches of one decode step with all 4 slots busy, then device
        time by kernel over two more (torch.profiler), after the counted
        run; idle share = 1 - device busy time / wall time of the two
        steps.  Returns (profile or None, launches of the one step)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.kernels import _lib

        for p in prompts:
            eng.submit(p, max_new_tokens=5, arrival_step=eng.current_step)
        eng.step()  # admits and prefills all four, then one decode
        _lib.reset_launches()
        eng.step()  # one decode step, counted
        torch.cuda.synchronize()
        step_launches = dict(_lib.launches)
        log(f"one decode step (4 slots): launches {step_launches}")
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            log("decode profile: this torch cannot trace the card (not measured)")
            eng.run()
            return None, step_launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            eng.step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        eng.run()
        by_name = self.device_us_by_name(prof)
        # an aten:: op's device time is that of the kernels it launched,
        # which have entries of their own: the busy time sums the kernels
        kernels = {name: us for name, us in by_name.items() if not name.startswith("aten::")}
        busy = sum(kernels.values())
        if busy == 0:
            log("decode profile: the profiler recorded no device time (not measured)")
            return None, step_launches
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        log(f"decode profile, 2 steps x 4 slots: wall {wall_us / 1e3:.1f} ms, device busy "
            f"{busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f}")
        for name, us in top:
            log(f"  {us / busy:6.1%}  {us / 1e3:8.2f} ms  {name[:90]}")
        # K2's kernel: the shared decode-attention core over the paged pool
        k2_us = sum(us for name, us in by_name.items()
                    if "decode_attention_core" in name and "true>" in name)
        log(f"  K2 (decode_attention_core, paged): {k2_us / busy:.2%} of device time, "
            f"{k2_us / 1e3:.3f} ms")
        # K1's and K3's kernels, and the device's copy kernels (casts
        # among them), by kernel name
        k1_us = sum(us for name, us in kernels.items() if "plam_matmul" in name)
        k3_us = sum(us for name, us in kernels.items() if "encode_" in name and "kernel" in name)
        copy_us = sum(us for name, us in kernels.items() if "copy" in name)
        log(f"  K1 {k1_us / 1e3:.3f} ms, K3 (weight encodes) {k3_us / 1e3:.3f} ms, copy "
            f"kernels {copy_us / 1e3:.3f} ms over the 2 steps")
        # the device kernels outside K1, K2 and K3 (casts, norms, rope, the
        # MoE dispatch's softmax, sort, cumsum, scatter and gather)
        glue = sorted(((name, us) for name, us in kernels.items()
                       if "plam_matmul" not in name and "decode_attention_core" not in name
                       and not ("encode_" in name and "kernel" in name)),
                      key=lambda kv: -kv[1])
        glue_us = sum(us for _, us in glue)
        log(f"  outside K1, K2 and K3: {glue_us / 1e3:.3f} ms ({glue_us / busy:.1%}) over "
            f"{len(glue)} kernel names; the top ones:")
        for name, us in glue[:8]:
            log(f"    {us / 1e3:8.3f} ms  {name[:100]}")
        return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
                "idle_share": 1 - busy / wall_us,
                "k2_ms": k2_us / 1e3, "k2_share": k2_us / busy,
                "k1_ms": k1_us / 1e3, "k3_ms": k3_us / 1e3, "copy_ms": copy_us / 1e3,
                "glue_ms": glue_us / 1e3,
                "glue_top": [[name, us / 1e3] for name, us in glue[:8]],
                "top": [[name, us / 1e3] for name, us in top]}, step_launches

    # -- phase 5 -------------------------------------------------------------

    def phase_serve_paths(self):
        """The multi-token paged path: the 2-layer model check, then the
        four engine runs at full width and depth on one prequantized
        model, each beside its plain run."""
        torch = self.torch
        from repro_torch.core.prequant import quantize_params
        from repro_torch.kernels import _lib
        from repro_torch.models import transformer as tf
        from repro_torch.serving import ServeOptions

        model_check = self.check_chunk_model()
        cfg = self.yi_cfg(32)
        layers = cfg.n_layers
        torch.cuda.reset_peak_memory_stats()
        model = tf.lm_init(cfg, seed=0, device=self.dev)
        quantize_params(cfg, model)  # the serve phase's weights, encoded once
        base = ServeOptions(max_new_tokens=16, block_size=16, max_slots=4, num_blocks=64,
                            max_seq_len=128, prequantize=True)
        g = torch.Generator().manual_seed(7)  # the serve phase's requests
        lens = torch.randint(32, 65, (4,), generator=g).tolist()
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist() for n in lens]
        serve = self.results.get("serve", {})
        if serve.get("layers") == layers and getattr(self, "serve_prompts", None) == prompts:
            plain = {"outputs": serve["outputs"], "prefill_s": serve["prefill_s"],
                     "prefills": serve["prefills"], "from": "phase serve"}
        else:
            run = self.serve_run("plain", cfg, model, base, prompts)
            plain = {**run, "from": "this phase"}
        res = {"layers": layers, "prompt_lens": lens, "model_check": model_check,
               "plain": {k: v for k, v in plain.items() if k != "calls"}}
        failures = []

        def hold(name, run, want, ctx_prompts):
            """Gate a run: its launches per forward, then its tokens against
            the plain run's (or the plain context's top-2 margin)."""
            res[name] = run
            failures.extend(f"{name}: {f}" for f in self.forward_gates(run, layers))
            diffs = self.token_diffs(cfg, model, ctx_prompts, run["outputs"], want)
            run["token_diffs"] = diffs
            for d in diffs:
                if d["plain_top2_margin"] >= E2E_LOGIT_TOL:
                    failures.append(f"{name}: tokens differ at {d} with a margin of at "
                                    f"least {E2E_LOGIT_TOL}")
            log(f"  {name}: greedy tokens "
                + ("equal to the plain run's" if not diffs else f"differ: {diffs}"))

        # 1. chunked prefill
        opts = dataclasses.replace(base, prefill_chunk=SERVE_CHUNK)
        run = self.serve_run("chunked", cfg, model, opts, prompts)
        log(f"  prefill s per request: chunked {run['prefill_s'] / len(prompts):.4f} "
            f"({run['prefills']} chunk forwards), whole-prompt "
            f"{plain['prefill_s'] / plain['prefills']:.4f} ({plain['from']})")
        hold("chunked", run, plain["outputs"], prompts)
        # 2. recompute preemption on the pool the longest request needs alone.
        # Under equal priorities the seeded requests would run one at a
        # time on it (a later arrival waits behind the earlier one and
        # never takes its blocks), so each arrival is given a higher
        # priority than the last: it preempts the request running, which
        # resumes through the chunk path later.
        from repro_torch.serving.kv_cache import BlockAllocator
        from repro_torch.serving.scheduler import Request, Scheduler

        sizer = Scheduler(BlockAllocator(2, base.block_size), base.max_slots, base.max_seq_len)
        need = max(sizer.blocks_needed(Request(rid=0, prompt=p, max_new_tokens=16))
                   for p in prompts)
        opts = dataclasses.replace(base, prefill_chunk=SERVE_CHUNK, preemption="recompute",
                                   num_blocks=need + 1)
        run = self.serve_run("preempt", cfg, model, opts, prompts,
                             priorities=range(len(prompts)))
        log(f"  preemption: pool {need} blocks, {run['preemptions']} preemptions, "
            f"{run['resumes']} resumes, resume latency mean {run['resume_latency_mean_s']:.4f} s "
            f"(steps {run['resume_latency_steps']})")
        if run["preemptions"] < 1 or run["resumes"] < 1:
            failures.append("preempt: no preemption or no resume")
        if not any(c[0] == "chunk" and c[3] for c in run["calls"]):
            failures.append("preempt: no resume went through the chunk path")
        hold("preempt", run, plain["outputs"], prompts)
        # 3. n-gram speculative decoding
        opts = dataclasses.replace(base, spec_k=SERVE_SPEC_K, spec_draft="ngram")
        run = self.serve_run("spec", cfg, model, opts, prompts)
        log(f"  spec: {run['spec_steps']} verify steps, acceptance rate "
            f"{run['acceptance_rate']:.4f}, tokens per verify step "
            f"{run['tokens_per_verify_step']:.4f}")
        if run["spec_steps"] < 1:
            failures.append("spec: no verify step ran")
        hold("spec", run, plain["outputs"], prompts)
        # 4. the prefix cache, on and off
        g = torch.Generator().manual_seed(23)
        shared = torch.randint(0, cfg.vocab, (PREFIX_LEN,), generator=g).tolist()
        pprompts = [shared + torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
                    for n in PREFIX_SUFFIX_LENS]
        pprompts.append(list(pprompts[0]))  # the exact repeat: copy-on-write
        off = self.serve_run("prefix_off", cfg, model, base, pprompts)
        res["prefix_off"] = off
        failures.extend(f"prefix_off: {f}" for f in self.forward_gates(off, layers))
        opts = dataclasses.replace(base, prefix_cache=True)
        run = self.serve_run("prefix", cfg, model, opts, pprompts)
        log(f"  prefix cache: cached_len {run['cached_len']} (sum {sum(run['cached_len'])}), "
            f"hits {run['cache']['hits']}, copies on write {run['cache']['cow_copies']}")
        if sum(run["cached_len"]) <= 0 or run["cache"]["cow_copies"] < 1:
            failures.append("prefix: no cache hit or no copy-on-write")
        hold("prefix", run, off["outputs"], pprompts)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        self.results["serve_paths"] = res
        for name in ("plam_matmul", "paged_decode_attention"):
            self.path_launches[name] = self.path_launches.get(name, 0) + sum(
                res[r]["launches"][name] for r in ("chunked", "preempt", "spec", "prefix"))
        if "observe" in self.args.phases.split(","):
            self.yi_model = model  # phase observe serves the same encoded weights
        del model
        torch.cuda.empty_cache()
        if failures:
            raise AssertionError("; ".join(failures))

    def serve_run(self, name, cfg, model, opts, prompts, priorities=None, new_tokens=16):
        """Serve ``prompts`` (one step apart, ``new_tokens`` new tokens each,
        the serve phase's 16 by default; ``priorities``, one a request, else
        0) on an engine over ``model``,
        the launch counts set to 0 just before the run and read just
        after.  Each forward's kind, M and launches are recorded by
        wrapping the engine's model API."""
        torch = self.torch
        import numpy as np

        from repro_torch.kernels import _lib
        from repro_torch.serving import build_engine

        eng = build_engine(cfg, opts, params=model)
        calls = []

        def counted(kind, fn):
            def call(model, tokens, *args, **kw):
                before = dict(_lib.launches)
                resume = kind == "chunk" and bool(eng._prefilling) and \
                    eng._prefilling[0].resume_ctx is not None
                out = fn(model, tokens, *args, **kw)
                calls.append((kind, tokens.numel(), {k: _lib.launches[k] - before[k]
                                                     for k in before}, resume))
                return out
            return call

        api = eng.api
        eng.api = dataclasses.replace(
            api, paged_prefill=counted("prefill", api.paged_prefill),
            paged_prefill_chunk=counted("chunk", api.paged_prefill_chunk),
            paged_decode_step=counted("decode", api.paged_decode_step),
            paged_score_tokens=counted("verify", api.paged_score_tokens))
        _lib.reset_launches()  # this path's run starts here
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_new_tokens=new_tokens, arrival_step=i, priority=pr)
                   for i, (p, pr) in enumerate(zip(prompts, priorities or [0] * len(prompts)))]
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_lib.launches)
        st = eng.stats
        ms = sorted({(kind, m) for kind, m, _, _ in calls})
        run = {"outputs": [done[h.rid] for h in handles], "wall_s": wall, "steps": st.steps,
               "prefills": st.prefills, "decode_steps": st.decode_steps,
               "prefill_s": st.prefill_s, "decode_s": st.decode_s,
               "step_p50_s": st.latency_p50(), "step_p95_s": st.latency_p95(),
               "decode_tokens": st.generated_tokens - len(prompts),
               "launches": counts, "calls": calls,
               "forward_m": ms, "preemptions": st.preemptions, "resumes": st.resumes,
               "resume_latency_mean_s": st.resume_latency_mean_s(),
               "resume_latency_steps": st.resume_latency_steps,
               "spec_steps": st.spec_steps, "acceptance_rate": st.acceptance_rate(),
               "tokens_per_verify_step": st.tokens_per_verify_step(),
               "cached_len": [h.cached_len for h in handles],
               "cache": {k: getattr(eng.allocator, k) for k in
                         ("hits", "misses", "tokens_saved", "cow_copies", "evictions")}}
        decode_tokens = st.generated_tokens - len(prompts)
        log(f"{name}: {len(done)} requests in {st.steps} steps, {wall:.2f} s wall: prefill "
            f"{st.prefill_s:.2f} s over {st.prefills} forwards, decode/verify {st.decode_s:.2f} s "
            f"over {st.decode_steps} steps ({decode_tokens / st.decode_s:.2f} tok/s), step p50 "
            f"{np.quantile(st.step_latency_s, 0.5) * 1e3:.1f} ms; forwards (kind, M) {ms}; "
            f"launches {counts}")
        del eng, handles
        return run

    def forward_gates(self, run, layers, counts=None):
        """Launches per forward: the model's K1 (``launch_counts``; 7L+1 for
        yi-6b) on every forward, L K2 on a one-token decode step and none on
        a prefill, chunk or verify forward, its K3 (none with int16 weights
        and an untied head: K1 encodes the activations; one a forward for a
        tied head) and nothing else."""
        counts = counts or {"k1": 7 * layers + 1, "k3": 0}
        bad = []
        for kind, m, got, _ in run["calls"]:
            want = {k: 0 for k in got}
            want["plam_matmul"] = counts["k1"]
            want["posit_codec"] = counts["k3"]
            want["paged_decode_attention"] = layers if kind == "decode" else 0
            if got != want:
                bad.append(f"{kind} forward at M={m}: launches {got}, expected {want}")
        total = sum(c[2]["plam_matmul"] for c in run["calls"])
        if total != run["launches"]["plam_matmul"] or total == 0:
            bad.append(f"K1 launched {run['launches']['plam_matmul']} times in the run, "
                       f"{total} in its counted forwards")
        return bad[:4]

    def token_diffs(self, cfg, model, prompts, got, want):
        """Each request whose greedy tokens differ from the plain run's: the
        first differing position and the plain context's top-2 logit margin
        there (a whole-context prefill of the prompt and the plain run's
        tokens before it, on the kernels)."""
        torch = self.torch
        from repro_torch.models import transformer as tf

        diffs = []
        for i, (g, w) in enumerate(zip(got, want)):
            if g == w:
                continue
            pos = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
            ctx = prompts[i] + w[:pos]
            bs = 16
            s_pad = -(-len(ctx) // bs) * bs
            toks = torch.zeros((1, s_pad), dtype=torch.int32, device=self.dev)
            toks[0, :len(ctx)] = torch.tensor(ctx, dtype=torch.int32)
            kp, vp = tf.paged_kv_pool_init(cfg, s_pad // bs + 1, bs, torch.bfloat16, self.dev)
            blocks = torch.arange(1, s_pad // bs + 1, dtype=torch.int32, device=self.dev)
            logits, _ = tf.paged_prefill(cfg, model, toks, kp, vp, blocks, len(ctx))
            top = torch.topk(logits[0, -1].float(), 2).values
            diffs.append({"request": i, "position": pos, "got": g[pos] if pos < len(g) else None,
                          "want": w[pos] if pos < len(w) else None,
                          "plain_top2_margin": float(top[0] - top[1])})
            del kp, vp
        return diffs

    def check_chunk_model(self):
        """At phase e2e's 2-layer full width: a 64-token prompt prefilled in
        two chunks of 32 against one whole-prompt prefill, both on the
        kernels; last logits within E2E_LOGIT_TOL, every written pool
        position within K2_TOL_BF16, and 7L+1 K1 launches a chunk, no K2
        and no K3."""
        torch = self.torch
        from repro_torch.core.prequant import quantize_params
        from repro_torch.kernels import _lib
        from repro_torch.models import transformer as tf

        cfg = self.yi_cfg(2)
        model = tf.lm_init(cfg, seed=1, device=self.dev)
        quantize_params(cfg, model)
        g = torch.Generator().manual_seed(19)
        prompt = torch.randint(0, cfg.vocab, (1, 64), generator=g).to(self.dev)
        bs = 16
        row = torch.tensor([1, 2, 3, 4, 0, 0, 0, 0, 0], dtype=torch.int32, device=self.dev)
        kp_a, vp_a = tf.paged_kv_pool_init(cfg, 8, bs, torch.bfloat16, self.dev)
        want, _ = tf.paged_prefill(cfg, model, prompt, kp_a, vp_a, row[:4], 64)
        kp_b, vp_b = tf.paged_kv_pool_init(cfg, 8, bs, torch.bfloat16, self.dev)
        _lib.reset_launches()
        for start in (0, SERVE_CHUNK):
            got, _ = tf.paged_prefill_chunk(cfg, model, prompt[:, start:start + SERVE_CHUNK],
                                            kp_b, vp_b, row, start, SERVE_CHUNK - 1)
        torch.cuda.synchronize()
        used = dict(_lib.launches)
        err = float((got.float() - want.float()).abs().max())
        pool_err = max(float((a[:, 1:5].float() - b[:, 1:5].float()).abs().max())
                       for a, b in ((kp_a, kp_b), (vp_a, vp_b)))
        agree = int(got.float().argmax()) == int(want.float().argmax())
        log(f"chunked prefill, 2-layer full width, 64 tokens in 2 chunks of {SERVE_CHUNK}: "
            f"last-logit max_abs_err {err:.3e} (tol {E2E_LOGIT_TOL}), pool max_abs_err "
            f"{pool_err:.3e} (tol {K2_TOL_BF16}), argmax {'equal' if agree else 'differs'}, "
            f"launches {used}")
        del model, kp_a, vp_a, kp_b, vp_b
        torch.cuda.empty_cache()
        expect = {k: 0 for k in used}
        expect["plam_matmul"] = 2 * (7 * cfg.n_layers + 1)
        if err > E2E_LOGIT_TOL or pool_err > K2_TOL_BF16 or used != expect:
            raise AssertionError(f"chunked prefill model check: err {err}, pool {pool_err}, "
                                 f"launches {used} (expected {expect})")
        return {"max_abs_err": err, "pool_max_abs_err": pool_err, "argmax_equal": agree,
                "launches": used}

    # -- phase 6 -------------------------------------------------------------

    def phase_observe(self):
        """Serving observability at full width and depth on the serve phase's
        requests and encoded weights: tracing on and off in turns (tokens,
        launches, the trace's grammar and breakdowns), the profiler spans
        with each kernel attributed to the span that launched it, the host's
        share of the decode step read with and without the profiler, and the
        serve CLI with its trace and metrics files."""
        torch = self.torch
        import numpy as np

        from repro_torch.core.prequant import quantize_params
        from repro_torch.models import transformer as tf
        from repro_torch.serving import ServeOptions

        cfg = self.yi_cfg(32)
        layers = cfg.n_layers
        model = getattr(self, "yi_model", None)
        self.yi_model = None
        if model is None:
            model = tf.lm_init(cfg, seed=0, device=self.dev)
            quantize_params(cfg, model)
        base = ServeOptions(max_new_tokens=16, block_size=16, max_slots=4, num_blocks=64,
                            max_seq_len=128, prequantize=True)
        g = torch.Generator().manual_seed(7)  # the serve phase's requests
        lens = torch.randint(32, 65, (4,), generator=g).tolist()
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist() for n in lens]
        failures = []
        res = {"layers": layers, "prompt_lens": lens}

        # 1. tracing off and on, in turns, on the same model
        runs = []
        for i in range(6):
            trace = bool(i % 2)
            run = self.observed_run(cfg, model, dataclasses.replace(base, trace=trace),
                                    prompts, failures, f"trace={trace} run {i // 2 + 1}")
            runs.append(run)
        want = runs[0]["outputs"]
        if any(r["outputs"] != want for r in runs):
            failures.append("greedy tokens differ between runs with tracing on and off")
        summary = {}
        for trace in (False, True):
            mine = [r for r in runs if r["trace"] == trace]
            summary[f"trace_{'on' if trace else 'off'}"] = {
                "step_p50_ms": [r["step_p50_ms"] for r in mine],
                "median_step_p50_ms": float(np.median([r["step_p50_ms"] for r in mine])),
                "decode_tok_per_s": [r["decode_tok_per_s"] for r in mine],
                "median_decode_tok_per_s": float(np.median(
                    [r["decode_tok_per_s"] for r in mine]))}
        on, off = summary["trace_on"], summary["trace_off"]
        log(f"observe: tracing off, step p50 {off['step_p50_ms']} ms (median "
            f"{off['median_step_p50_ms']:.3f}), decode tok/s {off['decode_tok_per_s']} (median "
            f"{off['median_decode_tok_per_s']:.3f}); on, step p50 {on['step_p50_ms']} ms "
            f"(median {on['median_step_p50_ms']:.3f}), decode tok/s {on['decode_tok_per_s']} "
            f"(median {on['median_decode_tok_per_s']:.3f})")
        res["runs"] = runs
        res["tracing"] = summary

        # 2. the spans under the profiler
        spans = self.profiled_spans(cfg, model, dataclasses.replace(base, profile=True),
                                    prompts, want, failures)
        res["spans"] = spans
        if spans is not None and "serve.decode" in spans["by_span"]:
            dec = spans["by_span"]["serve.decode"]
            host_ms = dec["host_ms"] / dec["count"]
            dev_ms = dec["device_ms"] / dec["count"]
            step_ms = on["median_step_p50_ms"]
            res["host_share"] = {
                "decode_span_host_ms": host_ms, "decode_span_device_ms": dev_ms,
                "under_profiler": 1 - dev_ms / host_ms,
                "trace_on_median_step_p50_ms": step_ms,
                "without_profiler": 1 - dev_ms / step_ms}
            log(f"host share of the decode step: under the profiler {1 - dev_ms / host_ms:.4f} "
                f"(serve.decode host {host_ms:.3f} ms, device {dev_ms:.3f} ms a span); without "
                f"it {1 - dev_ms / step_ms:.4f} (device {dev_ms:.3f} ms a span against the "
                f"tracing-on median step p50 {step_ms:.3f} ms)")
        del model
        torch.cuda.empty_cache()

        # 3. the CLI at full width, as a user runs it
        res["cli"] = self.observe_cli(failures)
        self.results["observe"] = res
        if failures:
            raise AssertionError("; ".join(failures[:8]))

    def observed_run(self, cfg, model, opts, prompts, failures, name):
        """Serve ``prompts`` one step apart on an engine over ``model``, the
        launch counts set to 0 just before the run and read just after;
        gate each forward's launches (7L+1 K1, no K3; L K2 a decode step)
        and, with tracing on, the trace's grammar and each request's
        breakdown against its submit -> terminal time."""
        torch = self.torch
        import numpy as np

        from repro_torch.kernels import _lib
        from repro_torch.serving import build_engine

        layers = cfg.n_layers
        eng = build_engine(cfg, opts, params=model)
        emit_s = [0.0]  # host seconds inside the trace recorder's emit
        if opts.trace:
            emit = eng.trace.emit

            def timed_emit(*args, **kw):
                t = time.perf_counter()
                ev = emit(*args, **kw)
                emit_s[0] += time.perf_counter() - t
                return ev
            eng.trace.emit = timed_emit
        _lib.reset_launches()  # this path's run starts here
        t0 = time.perf_counter()
        handles = [eng.submit(p, arrival_step=i, **opts.submit_kwargs())
                   for i, p in enumerate(prompts)]
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_lib.launches)
        for k in ("plam_matmul", "paged_decode_attention"):
            self.path_launches[k] = self.path_launches.get(k, 0) + counts[k]
        st = eng.stats
        forwards = st.prefills + st.decode_steps
        expect = {"plam_matmul": (7 * layers + 1) * forwards, "posit_codec": 0,
                  "paged_decode_attention": layers * st.decode_steps}
        bad = {k: (counts[k], v) for k, v in expect.items() if counts[k] != v}
        if bad:
            failures.append(f"{name}: launch counts (got, expected) {bad}")
        worst = 0.0
        if opts.trace:
            eng.trace.validate()
            for h in handles:
                evs, bd = h.trace(), h.breakdown()
                parts = bd.queue_s + bd.prefill_s + bd.decode_s + bd.parked_s
                worst = max(worst, abs(parts - bd.total_s),
                            abs(bd.total_s - (evs[-1].t - evs[0].t)))
            if worst > 1e-9:
                failures.append(f"{name}: a breakdown misses its total by {worst}")
        elif eng.trace is not None:
            failures.append(f"{name}: trace=False but the engine records a trace")
        decode_tokens = st.generated_tokens - st.prefills
        run = {"trace": opts.trace, "outputs": [done[h.rid] for h in handles], "wall_s": wall,
               "steps": st.steps, "decode_steps": st.decode_steps, "prefills": st.prefills,
               "step_p50_ms": st.latency_p50() * 1e3, "step_p95_ms": st.latency_p95() * 1e3,
               "decode_s": st.decode_s, "decode_tok_per_s": decode_tokens / st.decode_s,
               "launches": counts, "expected": expect, "breakdown_worst_err_s": worst,
               "events": len(eng.trace) if eng.trace is not None else 0,
               "emit_ms": emit_s[0] * 1e3}
        log(f"  {name}: {st.steps} steps, {wall:.2f} s wall, step p50 {run['step_p50_ms']:.3f} ms "
            f"p95 {run['step_p95_ms']:.3f} ms, {run['decode_tok_per_s']:.2f} decode tok/s, "
            f"{run['events']} events in {run['emit_ms']:.3f} ms of emit, launches {counts}")
        del eng, handles
        return run

    def profiled_spans(self, cfg, model, opts, prompts, want, failures):
        """One traced run with the engine's profiler spans inside
        ``torch.profiler``.  Each kernel, copy and fill on the card is
        attributed to the span whose host interval holds the runtime call
        that launched it (the correlation id joins the two in the exported
        trace); per span: count, host ms inside it, device ms of what it
        launched, and its K1/K2 launches.  Gate: every K1 launch inside a
        prefill, decode or verify span, every K2 launch inside a decode
        span, 7L+1 K1 and L K2 in each decode span.  The profiler's own
        ``key_averages()`` reading of the spans' device time is logged
        beside it."""
        torch = self.torch
        import tempfile

        from torch.profiler import ProfilerActivity, profile

        from repro_torch.serving import build_engine

        layers = cfg.n_layers
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            failures.append("spans: this torch cannot trace the card")
            return None
        eng = build_engine(cfg, opts, params=model)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            handles = [eng.submit(p, arrival_step=i, **opts.submit_kwargs())
                       for i, p in enumerate(prompts)]
            done = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        st = eng.stats
        if [done[h.rid] for h in handles] != want:
            failures.append("spans: greedy tokens differ from the unprofiled runs'")
        ka = {}
        for evt in prof.key_averages():
            if evt.key in OBSERVE_SPANS:
                us = getattr(evt, "device_time_total", None)
                if us is None:
                    us = getattr(evt, "cuda_time_total", 0)
                ka[evt.key] = {"count": evt.count, "cpu_ms": evt.cpu_time_total / 1e3,
                               "device_ms": us / 1e3}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        by_span, outside, per_decode, misplaced = attribute_to_spans(
            events["traceEvents"] if isinstance(events, dict) else events)
        dec = by_span.get("serve.decode", {"count": 0})
        if dec["count"] != st.decode_steps:
            failures.append(f"spans: {dec['count']} serve.decode spans for "
                            f"{st.decode_steps} decode steps")
        if misplaced:
            failures.append(f"spans: {len(misplaced)} K1/K2 launches outside their span, "
                            f"e.g. {misplaced[:3]}")
        wrong = [c for c in per_decode.values() if c != [7 * layers + 1, layers]]
        if wrong or len(per_decode) != dec["count"]:
            failures.append(f"spans: decode spans with (K1, K2) launches other than "
                            f"({7 * layers + 1}, {layers}): {wrong[:3]} "
                            f"({len(per_decode)} of {dec['count']} spans launched K1/K2)")
        busy = sum(r["device_ms"] for r in by_span.values()) + outside["device_ms"]
        log(f"spans under torch.profiler (one traced, profiled run, {st.steps} steps, "
            f"{wall * 1e3:.1f} ms wall, device busy {busy:.3f} ms): attributed by correlation "
            f"id from each runtime launch call to the span holding it")
        for name in OBSERVE_SPANS:
            if name in by_span:
                r = by_span[name]
                log(f"  {name}: {r['count']} spans, host {r['host_ms']:.3f} ms, device "
                    f"{r['device_ms']:.3f} ms, K1 {r['k1']}, K2 {r['k2']}; key_averages: "
                    f"{ka.get(name)}")
        log(f"  outside every span: device {outside['device_ms']:.3f} ms, K1 {outside['k1']}, "
            f"K2 {outside['k2']}, {outside['unmatched']} with no launch call found")
        del eng, handles
        return {"wall_ms": wall * 1e3, "busy_ms": busy, "steps": st.steps,
                "decode_steps": st.decode_steps, "by_span": by_span, "outside": outside,
                "key_averages": ka, "method": "correlation id"}

    def observe_cli(self, failures):
        """``python -m repro_torch.launch.serve`` at full width, once
        writing a Chrome trace and once JSON lines, each with a Prometheus
        file; the port's checkers must accept them, the per-mode MAC
        counter read above 0, and the summary line's steps equal
        ``serve_steps_total``."""
        import tempfile

        from repro_torch.serving.observability import check_prom_file, check_trace_file

        out = {}
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        with tempfile.TemporaryDirectory() as tmp:
            for trace in ("t.json", "t.jsonl"):
                prom = os.path.join(tmp, f"m_{trace}.prom")
                argv = OBSERVE_CLI + ["--trace-out", os.path.join(tmp, trace),
                                      "--metrics-out", prom]
                t0 = time.perf_counter()
                proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"] + argv,
                                      cwd=ROOT, env=env, capture_output=True, text=True,
                                      timeout=OBSERVE_CLI_TIMEOUT_S)
                secs = time.perf_counter() - t0
                lines = proc.stdout.splitlines()
                run = {"argv": argv, "rc": proc.returncode, "seconds": secs,
                       "stdout": lines[:20]}
                out[trace] = run
                if proc.returncode != 0:
                    failures.append(f"cli ({trace}): exit {proc.returncode}: "
                                    f"{proc.stderr.strip().splitlines()[-3:]}")
                    continue
                log(f"serve CLI ({secs:.1f} s, --trace-out {trace}): {lines[0]}")
                text = open(prom).read()
                run["prom_samples"] = check_prom_file(prom)
                if trace.endswith(".jsonl"):
                    run["trace_counts"] = check_trace_file(os.path.join(tmp, trace))
                    if run["trace_counts"]["terminal"] != 4:
                        failures.append(f"cli: trace counts {run['trace_counts']}")
                else:
                    with open(os.path.join(tmp, trace)) as f:
                        phs = {e["ph"] for e in json.load(f)["traceEvents"]}
                    if not {"X", "i", "M"} <= phs:
                        failures.append(f"cli: the Chrome trace holds only {phs}")
                macs = re.search(r'^serve_macs_total\{mode="plam_sim:16:1"\} (\S+)$', text, re.M)
                run["macs_plam"] = float(macs.group(1)) if macs else None
                if not macs or float(macs.group(1)) <= 0:
                    failures.append("cli: serve_macs_total{mode=\"plam_sim:16:1\"} missing or 0")
                fams = sorted(set(re.findall(r"^(serve_prefix_cache_\w+)", text, re.M)))
                run["prefix_cache_families"] = fams
                if len(fams) < 4:
                    failures.append(f"cli: prefix-cache families {fams}")
                steps = re.search(r" steps=(\d+)", lines[0])
                total = re.search(r"^serve_steps_total (\S+)$", text, re.M)
                run["steps"] = int(steps.group(1)) if steps else None
                if not steps or not total or float(total.group(1)) != int(steps.group(1)):
                    failures.append(f"cli: steps= {steps and steps.group(1)} against "
                                    f"serve_steps_total {total and total.group(1)}")
        return out

    # -- phase 7 -------------------------------------------------------------

    def moe_cfg(self, arch):
        """``arch`` at full width, its depth cut by --layers, under the serve
        phase's policy."""
        from repro_torch.configs import get_config

        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, n_layers=min(self.args.layers, cfg.n_layers))
        return cfg.with_numerics("default=plam_sim:16:1")

    def moe_prompts(self, vocab):
        """The serve phase's four seeded prompts (32-64 tokens of yi-6b's
        64,000-token vocabulary), each token taken modulo ``vocab``."""
        torch = self.torch
        g = torch.Generator().manual_seed(7)
        lens = torch.randint(32, 65, (4,), generator=g).tolist()
        prompts = [torch.randint(0, 64000, (n,), generator=g).tolist() for n in lens]
        return lens, [[t % vocab for t in p] for p in prompts]

    def moe_gates(self, run, cfg, encodes):
        """Launches per forward of a MoE model: (7 + 3 with shared experts) L
        + 1 K1, 3L of them over a stack of experts; K3 as many as K1 when
        the weights are encoded on every forward, else none; L K2 on a
        one-token decode step and none on a prefill; nothing else."""
        layers = cfg.n_layers
        k1 = (7 + (3 if cfg.n_shared_experts else 0)) * layers + 1
        bad = []
        for kind, m, got, _ in run["calls"]:
            want = {k: 0 for k in got}
            want.update(plam_matmul=k1, plam_matmul_grouped=3 * layers,
                        posit_codec=k1 if encodes else 0,
                        paged_decode_attention=layers if kind == "decode" else 0)
            if got != want:
                bad.append(f"{kind} forward at M={m}: launches {got}, expected {want}")
        for name in ("plam_matmul", "plam_matmul_grouped"):
            total = sum(c[2][name] for c in run["calls"])
            if total != run["launches"][name] or total == 0:
                bad.append(f"{name} launched {run['launches'][name]} times in the run, "
                           f"{total} in its counted forwards")
        return bad[:4]

    def count_moe_path(self, launches):
        """Adds a MoE run's launches to the kernels line, each launch in one
        row: K1 over a stack of experts under plam_matmul_grouped only."""
        own = dict(launches, plam_matmul=launches["plam_matmul"]
                   - launches["plam_matmul_grouped"])
        for name in ("plam_matmul", "plam_matmul_grouped", "paged_decode_attention"):
            self.path_launches[name] = self.path_launches.get(name, 0) + own[name]

    @contextlib.contextmanager
    def recording_caps(self):
        """The set of every cap (the M of an expert's buffer) that
        ``moe.route`` is given while the block runs."""
        from repro_torch.models import moe as moe_mod

        route, caps = moe_mod.route, set()

        def recorded(logits, top_k, cap):
            caps.add(cap)
            return route(logits, top_k, cap)

        moe_mod.route = recorded
        try:
            yield caps
        finally:
            moe_mod.route = route

    def check_moe_caps(self, arch, moe, caps, failures) -> dict:
        """Grouped K1 at every cap the runs of ``arch`` reached, on layer 0's
        int16 expert stacks (wg: K = d, N = f; wd: K = f, N = d; wu is wg's
        shape) with bf16 A, as the path gives them: the first
        K1_GROUPED_PLAIN_E experts against the grouped plain version, every
        expert against the 2-D kernel, bit for bit."""
        torch = self.torch
        from repro_torch.kernels.plam_matmul import plam_matmul_float
        from repro_torch.numerics import P16

        g, cases, n_before, plain_e = self.gen(23), 0, len(failures), K1_GROUPED_PLAIN_E
        for m in sorted(caps):
            for name in ("wg", "wd"):
                w = getattr(moe, name)
                e, k, n = w.shape
                x = torch.randn((e, m, k), generator=g, device=self.dev).to(torch.bfloat16)
                got = plam_matmul_float(x, w, P16)
                plain = plam_matmul_float(x[:plain_e], w[:plain_e], P16, use_kernel=False)
                per = torch.stack([plam_matmul_float(x[i], w[i], P16) for i in range(e)])
                for what, part, want in (("plain", got[:plain_e], plain), ("2-D", got, per)):
                    if not torch.equal(part.view(torch.int32), want.view(torch.int32)):
                        failures.append(f"{arch} grouped K1 M={m} {name} (K={k}, N={n}): "
                                        f"differs from the {what} version")
                    cases += 1
            torch.cuda.synchronize()
        ok = len(failures) == n_before
        log(f"  {arch} grouped K1 at the caps its runs reached {sorted(caps)}, layer 0's wg "
            f"and wd, bf16 A: {'bit-identical' if ok else failures[n_before:]} over {cases} "
            f"cases (the first {plain_e} experts against the plain version, all against the "
            f"2-D kernel)")
        return {"caps": sorted(caps), "cases": cases, "ok": ok}

    def phase_moe(self):
        """The MoE family at full width on the serve phase's requests:
        deepseek-moe-16b (all 28 layers unless --layers cuts them) with its
        bf16 weights encoded on every forward, then encoded once in place
        (quantize_params) and served again (the same greedy tokens), read
        under the profiler; then granite-moe-1b-a400m, prequantized, served
        twice (the same tokens: the run is deterministic).  After
        each model's runs, grouped K1 is held to its plain version and to
        the 2-D kernel at every cap those runs reached."""
        torch = self.torch
        import gc

        import numpy as np

        from repro_torch.core.prequant import quantize_params
        from repro_torch.kernels import _lib
        from repro_torch.models import transformer as tf
        from repro_torch.serving import ServeOptions, build_engine

        self.yi_model = None  # the earlier phases' model
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log(f"moe: {free / 2**30:.2f} GiB free of {total / 2**30:.2f} GiB, "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, after freeing the "
            f"earlier phases' models")
        res = {"free_gib_at_start": free / 2**30}
        failures = []
        base = ServeOptions(max_new_tokens=16, block_size=16, max_slots=4, num_blocks=64,
                            max_seq_len=128, prequantize=False)

        # 1. deepseek-moe-16b, bf16 weights encoded on every forward
        cfg = self.moe_cfg("deepseek-moe-16b")
        layers = cfg.n_layers
        lens, prompts = self.moe_prompts(cfg.vocab)
        log(f"moe: deepseek-moe-16b d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv} hd "
            f"{cfg.hd} experts {cfg.n_experts} top-{cfg.top_k} moe_d_ff {cfg.moe_d_ff} shared "
            f"{cfg.n_shared_experts} vocab {cfg.vocab} layers {layers} param/act "
            f"{cfg.param_dtype}/{cfg.act_dtype} policy default=plam_sim:16:1; prompt lens {lens}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = tf.lm_init(cfg, seed=0, device=self.dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        bf16_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        log(f"  seeded init {init_s:.1f} s: {n_params / 1e9:.3f} G parameters, "
            f"{bf16_bytes / 1e9:.2f} GB, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        with self.recording_caps() as caps:
            plain = self.serve_run("deepseek bf16 weights", cfg, model, base, prompts)
        failures.extend(f"bf16 weights: {f}" for f in self.moe_gates(plain, cfg, True))
        res["deepseek_bf16"] = {k: v for k, v in plain.items() if k != "calls"}

        # 2. the same weights encoded once, in place
        _lib.reset_launches()
        t0 = time.perf_counter()
        _, meta = quantize_params(cfg, model)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        at_build = dict(_lib.launches)
        router = model.blocks[0].moe.router
        int16_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        log(f"  quantize_params in place {quant_s:.2f} s: {at_build['posit_codec']} encodes "
            f"({at_build['posit_codec_table']} table builds), {len(meta)} sites, router "
            f"{router.dtype}; weights {int16_bytes / 1e9:.2f} GB, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if at_build["posit_codec"] != 10 * layers + 1:
            failures.append(f"quantize_params: {at_build['posit_codec']} encodes, expected "
                            f"{10 * layers + 1}")
        if router.dtype != torch.float32 or "layers/moe/router" in meta:
            failures.append("quantize_params: the router did not stay f32")
        torch.cuda.reset_peak_memory_stats()
        with self.recording_caps() as more:
            run = self.serve_run("deepseek prequantized", cfg, model, base, prompts)
        caps |= more
        failures.extend(f"prequantized: {f}" for f in self.moe_gates(run, cfg, False))
        if run["outputs"] != plain["outputs"]:
            failures.append("deepseek: greedy tokens differ between the bf16 and the "
                            "prequantized weights")
        decode_tok_s = run["decode_tokens"] / run["decode_s"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  deepseek prequantized: decode {decode_tok_s:.2f} tok/s, step p50 "
            f"{run['step_p50_s'] * 1e3:.2f} ms, p95 {run['step_p95_s'] * 1e3:.2f} ms, prefill "
            f"{run['prefill_s']:.3f} s over {run['prefills']} prefills, peak {peak:.2f} GiB "
            f"(weights {int16_bytes / 2**30:.2f} GiB); tokens "
            f"{'equal to' if run['outputs'] == plain['outputs'] else 'DIFFER from'} the bf16 "
            f"run's")
        self.count_moe_path(run["launches"])
        self.path_launches["posit_codec"] = (self.path_launches.get("posit_codec", 0)
                                             + at_build["posit_codec"])
        eng = build_engine(cfg, base, params=model)
        profile, step_launches = self.profile_decode(eng, prompts)
        del eng
        step_want = {"plam_matmul": 10 * layers + 1, "plam_matmul_grouped": 3 * layers,
                     "paged_decode_attention": layers, "posit_codec": 0}
        step_bad = {k: (step_launches[k], v) for k, v in step_want.items()
                    if step_launches[k] != v}
        if step_bad:
            failures.append(f"deepseek decode step launches (got, expected): {step_bad}")
        ds_caps = self.check_moe_caps("deepseek-moe-16b", model.blocks[0].moe, caps, failures)
        res["deepseek"] = {
            "layers": layers, "prompt_lens": lens, "params": n_params, "init_s": init_s,
            "bf16_weight_bytes": bf16_bytes, "int16_weight_bytes": int16_bytes,
            "quantize_s": quant_s, "encodes_at_build": at_build["posit_codec"],
            "meta_sites": len(meta), "decode_tok_per_s": decode_tok_s, "peak_gib": peak,
            "tokens_equal": run["outputs"] == plain["outputs"],
            "decode_step_launches": step_launches, "decode_profile": profile,
            "k1_at_caps": ds_caps, **{k: v for k, v in run.items() if k != "calls"}}
        del model, router
        gc.collect()
        torch.cuda.empty_cache()

        # 3. granite-moe-1b-a400m, prequantized
        cfg = self.moe_cfg("granite-moe-1b-a400m")
        layers = cfg.n_layers
        _, prompts = self.moe_prompts(cfg.vocab)
        log(f"moe: granite-moe-1b-a400m d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv} "
            f"hd {cfg.hd} experts {cfg.n_experts} top-{cfg.top_k} moe_d_ff {cfg.moe_d_ff} vocab "
            f"{cfg.vocab} layers {layers}, prequantized")
        model = tf.lm_init(cfg, seed=0, device=self.dev)
        quantize_params(cfg, model)
        with self.recording_caps() as caps:
            run = self.serve_run("granite prequantized", cfg, model, base, prompts)
        failures.extend(f"granite: {f}" for f in self.moe_gates(run, cfg, False))
        if not all(len(o) == 16 and all(0 <= t < cfg.vocab for t in o) for o in run["outputs"]):
            failures.append("granite: a request did not return 16 valid tokens")
        # idle slots' rows steer the capacity drops of live ones: a second
        # run must give the same tokens
        again = self.serve_run("granite prequantized, again", cfg, model, base, prompts)
        if again["outputs"] != run["outputs"]:
            failures.append("granite: a second run of the same requests gave other tokens")
        log(f"  granite prequantized: decode {run['decode_tokens'] / run['decode_s']:.2f} tok/s, "
            f"step p50 {run['step_p50_s'] * 1e3:.2f} ms, p95 {run['step_p95_s'] * 1e3:.2f} ms")
        eng = build_engine(cfg, base, params=model)
        profile, _ = self.profile_decode(eng, prompts)
        del eng
        g_caps = self.check_moe_caps("granite-moe-1b-a400m", model.blocks[0].moe, caps, failures)
        res["granite"] = {"layers": layers, "k1_at_caps": g_caps,
                          "tokens_repeat": again["outputs"] == run["outputs"],
                          "decode_tok_per_s": run["decode_tokens"] / run["decode_s"],
                          "decode_profile": profile,
                          **{k: v for k, v in run.items() if k != "calls"}}
        self.count_moe_path(run["launches"])
        del model
        gc.collect()
        torch.cuda.empty_cache()
        self.results["moe"] = res
        if failures:
            raise AssertionError("; ".join(failures[:8]))

    # -- phase 8 -------------------------------------------------------------

    def static_prompts(self, vocab, batch, length, seed):
        """``batch`` seeded prompts of ``length`` tokens, int32 [batch, length]."""
        torch = self.torch
        g = torch.Generator().manual_seed(seed)
        return torch.randint(0, vocab, (batch, length), generator=g, dtype=torch.int32)

    def counting_plain(self):
        """Calls of K1's and K3's plain versions on CUDA tensors while the
        block runs (there should be none: every wrapper launches its
        kernel on a CUDA tensor)."""
        from repro_torch.kernels import plam_matmul as k1_mod
        from repro_torch.kernels import posit_codec

        return self.counting_cuda_calls(
            ((k1_mod, "plam_matmul_seqref"), (posit_codec, "encode_plain"),
             (posit_codec, "decode_plain"), (posit_codec, "quantize_plain")))

    def counting_codec(self):
        """Calls of K3's decode and quantize wrappers on CUDA tensors while
        the block runs."""
        from repro_torch.kernels import posit_codec

        return self.counting_cuda_calls(((posit_codec, "posit_decode"),
                                         (posit_codec, "posit_quantize")))

    @contextlib.contextmanager
    def counting_cuda_calls(self, targets):
        """Calls of each (module, name) function on a CUDA tensor (its first
        argument) while the block runs, by name."""
        calls, saved = {}, []
        for mod, name in targets:
            real = getattr(mod, name)
            saved.append((mod, name, real))
            calls[name] = 0

            def counted(x, *a, _real=real, _name=name, **kw):
                calls[_name] += int(x.is_cuda)
                return _real(x, *a, **kw)

            setattr(mod, name, counted)
        try:
            yield calls
        finally:
            for mod, name, real in saved:
                setattr(mod, name, real)

    def static_run(self, name, eng, prompts, new_tokens, extra=None):
        """``eng.generate`` (the static engine, ``time_steps``) over
        ``prompts`` (and ``extra``, the vlm's ``embeds_prefix`` or the
        encdec's ``frames``) on the card, the launch counts set to 0 just
        before the run and read just after.  Each forward's kind, M and
        launches are recorded by wrapping the engine's model API, with each
        row's top-2 logit margin (the margin behind the token that step
        picks), whether every logit is finite, and the first decode step's
        last logits (``first_decode``)."""
        torch = self.torch
        import numpy as np

        from repro_torch.kernels import _lib
        from repro_torch.serving import ServeConfig

        calls, finite, margins, first = [], [], [], []
        api = eng.api

        def counted(kind, fn):
            def call(model, batch, use_kernel=None):
                before = dict(_lib.launches)
                logits, caches = fn(model, batch, use_kernel=use_kernel)
                m = batch["tokens" if kind == "prefill" else "token"].numel()
                calls.append((kind, m, {k: _lib.launches[k] - before[k] for k in before}))
                last = logits[:, -1].float()
                if kind == "decode" and not first:
                    first.append(last.clone())
                finite.append(torch.isfinite(logits).all())
                top = torch.topk(last, 2, dim=-1).values
                margins.append(top[:, 0] - top[:, 1])
                return logits, caches
            return call

        eng.api = dataclasses.replace(api, prefill=counted("prefill", api.prefill),
                                      decode_step=counted("decode", api.decode_step))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()  # this path's run starts here
        t0 = time.perf_counter()
        try:
            out = eng.generate({"tokens": prompts.to(self.dev), **(extra or {})},
                               ServeConfig(max_new_tokens=new_tokens, time_steps=True))
            torch.cuda.synchronize()
        finally:
            eng.api = api
        wall = time.perf_counter() - t0
        counts = dict(_lib.launches)
        lat = list(eng.stats.step_latency_s)
        decode = lat[1:]
        b = prompts.shape[0]
        run = {"outputs": out.cpu().tolist(), "wall_s": wall, "prefill_s": lat[0],
               "decode_steps": len(decode), "decode_tok_per_s": b * len(decode) / sum(decode),
               "step_p50_s": float(np.quantile(decode, 0.5)),
               "step_p95_s": float(np.quantile(decode, 0.95)),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts,
               "calls": calls, "finite": bool(torch.stack(finite).all()),
               "first_decode": first[0] if first else None,
               "margins": torch.stack(margins).cpu().tolist(),
               "stats": {f: getattr(eng.stats, f) for f in
                         ("steps", "prefills", "prefill_tokens", "decode_steps",
                          "active_slot_steps", "generated_tokens")}}
        log(f"  {name}: {b} x {prompts.shape[1]} tokens, {new_tokens} new, {wall:.2f} s wall: "
            f"prefill {lat[0]:.3f} s, decode {run['decode_tok_per_s']:.2f} tok/s (step p50 "
            f"{run['step_p50_s'] * 1e3:.2f} ms, p95 {run['step_p95_s'] * 1e3:.2f} ms), peak "
            f"{run['peak_gib']:.2f} GiB; launches {({k: v for k, v in counts.items() if v})}")
        return run

    def static_gates(self, run, k1, k3, prefill=None, outside=(0, 0)):
        """Launches per forward: ``k1`` K1 and ``k3`` K3 (weight encodes or
        quantizes) on a decode step, ``prefill`` = (K1, K3) on a prefill
        (by default the same), no K2, K5, table build or anything else; the
        K1 and K3 launches of the counted forwards and ``outside`` them
        (the encdec's second encoder pass, which the engine runs beside
        its first decode step) are all of the run's; every logit finite."""
        bad = []
        for kind, m, got in run["calls"]:
            want = {k: 0 for k in got}
            w1, w3 = prefill if (prefill and kind == "prefill") else (k1, k3)
            want.update(plam_matmul=w1, posit_codec=w3)
            if got != want:
                bad.append(f"{kind} forward at M={m}: launches "
                           f"{ {k: v for k, v in got.items() if v} }, expected K1 {w1}, K3 {w3}")
        for key, extra in zip(("plam_matmul", "posit_codec"), outside):
            total = sum(c[2][key] for c in run["calls"]) + extra
            if total != run["launches"][key]:
                bad.append(f"{key} launched {run['launches'][key]} times in the run, "
                           f"{total} in its counted forwards and beside them")
        if not run["finite"]:
            bad.append("a logit is not finite")
        return bad[:4]

    @staticmethod
    def static_diffs(got, want):
        """Each row whose tokens differ from ``want``'s: the first differing
        position and ``want``'s own top-2 margin at the step that picked
        it (both runs saw the same context up to there)."""
        diffs = []
        for i, (g, w) in enumerate(zip(got["outputs"], want["outputs"])):
            if g != w:
                pos = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
                diffs.append({"row": i, "position": pos, "got": g[pos], "want": w[pos],
                              "plain_top2_margin": want["margins"][pos][i]})
        return diffs

    def static_extension(self, cfg, model, prompts):
        """The reference's test_ssm_decode_matches_prefill_extension at full
        width on the kernels: decode of token t after a prefill of t
        tokens against the last logits of a prefill of t + 1 tokens.  The
        hybrid prefills into caches of t + 1 positions (the engine's
        caches of t would clamp the decode's K/V onto the last prompt
        token's slot, as the reference's do).  Returns the largest and
        the mean absolute logit difference, and, for scale, the largest
        between the prefill of t + 1 tokens in SSD chunks of (t + 1) / 4
        and in one chunk: the same function in another f32 order."""
        torch = self.torch
        from repro_torch.models import build
        from repro_torch.models import hybrid

        api = build(cfg)
        prompts = prompts.to(self.dev)
        b, t = prompts.shape[0], prompts.shape[1] - 1
        want, _ = api.prefill(model, {"tokens": prompts})
        if cfg.family == "hybrid":
            caches = hybrid.cache_init(cfg, b, t + 1, torch.bfloat16, self.dev)
            _, caches = hybrid.prefill(cfg, model, prompts[:, :t], caches)
        else:
            _, caches = api.prefill(model, {"tokens": prompts[:, :t]})
        got, _ = api.decode_step(model, {"token": prompts[:, t:], "caches": caches,
                                         "cache_len": t})
        diff = (got[:, 0].float() - want[:, 0].float()).abs()
        chunked, _ = build(dataclasses.replace(cfg, ssm_chunk=(t + 1) // 4)).prefill(
            model, {"tokens": prompts})
        return (float(diff.max()), float(diff.mean()),
                float((chunked[:, 0].float() - want[:, 0].float()).abs().max()))

    def static_profile(self, eng, prompts, extra=None, prefilled=None):
        """Two decode steps of the static engine under torch.profiler, after
        a prefill (or the caller's ``prefilled`` (logits, caches) of
        ``prompts``) and one decode step outside it: wall, device busy time,
        idle share (1 - busy / wall), K1's and K3's device time and the
        top device ops."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.serving import ServeConfig

        api, model, scfg = eng.api, eng.model, ServeConfig()
        batch0 = {"tokens": prompts.to(self.dev), **(extra or {})}
        pos0 = prompts.shape[1] + (batch0["embeds_prefix"].shape[1]
                                   if "embeds_prefix" in batch0 else 0)
        logits, caches = prefilled or api.prefill(model, batch0)
        caches = eng._grow_caches(caches, 4)
        eng._enc_cache = None
        state = {"tok": eng._pick(logits[:, -1, :], scfg, 0), "caches": caches}

        def step(i):
            batch = {"token": state["tok"][:, None], "cache_len": pos0 + i,
                     **eng._cache_kw(state["caches"], batch0)}
            logits, state["caches"] = api.decode_step(model, batch)
            state["tok"] = eng._pick(logits[:, -1, :], scfg, i + 1)

        step(0)
        torch.cuda.synchronize()
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            log("  decode profile: this torch cannot trace the card (not measured)")
            return None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(1)
            step(2)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name = self.device_us_by_name(prof, lambda evt: not evt.key.startswith("aten::"))
        busy = sum(by_name.values())
        if busy == 0:
            log("  decode profile: the profiler recorded no device time (not measured)")
            return None
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        k1_us = sum(us for name, us in by_name.items() if "plam_matmul" in name)
        k3_us = sum(us for name, us in by_name.items() if "encode_" in name and "kernel" in name)
        log(f"  decode profile, 2 steps x {prompts.shape[0]} rows: wall {wall_us / 1e3:.2f} ms, "
            f"device busy {busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}; K1 "
            f"{k1_us / 1e3:.3f} ms, K3 {k3_us / 1e3:.3f} ms, the rest {(busy - k1_us - k3_us) / 1e3:.3f}"
            f" ms over {len(by_name)} kernel names; the top ones:")
        for name, us in top:
            log(f"    {us / busy:6.1%}  {us / 1e3:8.3f} ms  {name[:90]}")
        return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
                "k1_ms": k1_us / 1e3, "k3_ms": k3_us / 1e3, "kernel_names": len(by_name),
                "top": [[name, us / 1e3] for name, us in top]}

    def static_k1_times(self, arch):
        """K1 over bf16 activations and int16 weights at ``arch``'s new
        (K, N), at a decode step's M and a prefill's, window and spun,
        beside its plain version's time (one call) and its bound (bytes:
        A, B and C once each; operations: one integer add a product at
        the int32 rate)."""
        torch = self.torch
        from repro_torch.kernels.ops import plam_dense
        from repro_torch.kernels.posit_codec import posit_encode
        from repro_torch.numerics import P16

        g, rows, int_rate = self.gen(31), [], self.int32_ops_per_s()
        for k, n in STATIC_K1_SHAPES[arch]:
            b = posit_encode(torch.randn((k, n), generator=g, device=self.dev) * k ** -0.5,
                             P16, out_dtype=torch.int16)
            for m in (STATIC_BATCH, STATIC_BATCH * STATIC_PROMPT):
                x = torch.randn((m, k), generator=g, device=self.dev).to(torch.bfloat16)
                ms, dev_ms = self.timed(lambda: plam_dense(x, b, P16), reps=10)
                plain = self.events_ms(lambda: plam_dense(x, b, P16, use_kernel=False),
                                       reps=1, warmup=0)
                t_bytes = (m * k * 2 + k * n * 2 + m * n * 4) / HBM_BYTES_PER_S * 1e3
                t_ops = m * k * n / int_rate * 1e3
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                rows.append({"m": m, "k": k, "n": n, "ms": ms, "device_ms": dev_ms,
                             "plain_ms": plain, "bound_ms": bound, "bound_by": by})
                log(f"  time K1 M={m} K={k} N={n} (bf16 A, int16 B): {ms:.4f} ms, device "
                    f"{dev_ms:.4f} ms (plain {plain:.1f} ms); bound {bound:.4f} ms by {by} "
                    f"({dev_ms / bound:.2f}x)")
                del x
            del b
        return rows

    def static_model(self, arch, failures):
        """One state-space arch at its config's full width and depth under
        default=plam_sim:16:1: int16 prequantized weights, then bf16 weights
        encoded on every forward, each on STATIC_BATCH x STATIC_PROMPT
        prompts and then STATIC_LONG_BATCH x STATIC_LONG_PROMPT; the
        decode-after-prefill check; two profiled decode steps; K1 at its
        new shapes.  mamba2 also under its config's own posit_quant."""
        torch = self.torch
        import gc

        from repro_torch.configs import get_config
        from repro_torch.core.prequant import quantize_params
        from repro_torch.kernels import _lib
        from repro_torch.models import build
        from repro_torch.serving import Engine, ServeConfig

        cfg = get_config(arch)
        native = cfg.numerics
        cfg = cfg.with_numerics("default=plam_sim:16:1")
        k1 = launch_counts(cfg)["k1"]
        res = {"layers": cfg.n_layers, "k1_per_forward": k1}
        log(f"static: {arch} family {cfg.family} d_model {cfg.d_model} d_inner "
            f"{cfg.ssm_expand * cfg.d_model} ssm heads "
            f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} x {cfg.ssm_head_dim} state "
            f"{cfg.ssm_state} chunk {cfg.ssm_chunk} vocab {cfg.vocab} layers {cfg.n_layers}"
            + (f", shared attention every {cfg.shared_attn_every} ({cfg.n_heads}/{cfg.n_kv} heads "
               f"of {2 * cfg.d_model // cfg.n_heads}, d_ff {cfg.d_ff})"
               if cfg.family == "hybrid" else "")
            + f"; policy default=plam_sim:16:1, {k1} K1 a forward")
        short = self.static_prompts(cfg.vocab, STATIC_BATCH, STATIC_PROMPT, 13)
        long = self.static_prompts(cfg.vocab, STATIC_LONG_BATCH, STATIC_LONG_PROMPT, 17)
        api = build(cfg)

        # 1. int16 prequantized weights
        t0 = time.perf_counter()
        model = api.init(seed=0, device=self.dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        _lib.reset_launches()
        t0 = time.perf_counter()
        _, meta = quantize_params(cfg, model)
        torch.cuda.synchronize()
        encodes = _lib.launches["posit_codec"]
        int16_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
        log(f"  seeded init {init_s:.1f} s: {n_params / 1e9:.3f} G parameters; quantize_params "
            f"{time.perf_counter() - t0:.2f} s: {encodes} encodes, {len(meta)} sites, "
            f"{int16_gb:.2f} GB of weights")
        self.path_launches["posit_codec"] = self.path_launches.get("posit_codec", 0) + encodes
        # each weight once: the shared block's 8 once, however often it runs
        want_encodes = launch_counts(cfg)["build"]
        if encodes != want_encodes:
            failures.append(f"{arch}: {encodes} weight encodes at build, expected "
                            f"{want_encodes}")
        eng = Engine(cfg, params=model, device=self.dev)
        # the model's first forwards (cuBLAS handles, the allocator), outside the counted runs
        eng.generate({"tokens": short[:, :8].to(self.dev)}, ServeConfig(max_new_tokens=2))
        pq = {"short": self.static_run(f"{arch} prequantized", eng, short, STATIC_NEW),
              "long": self.static_run(f"{arch} prequantized", eng, long, STATIC_NEW)}
        for kind, run in pq.items():
            failures.extend(f"{arch} prequantized {kind}: {f}"
                            for f in self.static_gates(run, k1, 0))
            self.path_launches["plam_matmul"] = (self.path_launches.get("plam_matmul", 0)
                                                 + run["launches"]["plam_matmul"])
        ext, mean_ext, chunked = self.static_extension(cfg, model, short)
        log(f"  decode of token {STATIC_PROMPT - 1} after a prefill of {STATIC_PROMPT - 1} "
            f"against a prefill of {STATIC_PROMPT}: max |logit difference| {ext:.4f} (mean "
            f"{mean_ext:.5f}; tolerance {E2E_LOGIT_TOL}); for scale, the same prefill with "
            f"SSD chunks of {STATIC_PROMPT // 4} against one chunk, max {chunked:.4f} (not "
            f"gated)")
        if not ext <= E2E_LOGIT_TOL:
            failures.append(f"{arch}: decode after prefill {ext:.4f} from the prefill extension")
        profile = self.static_profile(eng, short)
        del eng, model
        gc.collect()
        torch.cuda.empty_cache()

        # 2. bf16 weights, encoded by K3 before each K1 launch
        model = api.init(seed=0, device=self.dev)
        eng = Engine(cfg, params=model, device=self.dev)
        bf = {"short": self.static_run(f"{arch} bf16 weights", eng, short, STATIC_NEW),
              "long": self.static_run(f"{arch} bf16 weights", eng, long, STATIC_NEW)}
        for kind, run in bf.items():
            failures.extend(f"{arch} bf16 {kind}: {f}" for f in self.static_gates(run, k1, k1))
            self.path_launches["posit_codec"] = (self.path_launches.get("posit_codec", 0)
                                                 + run["launches"]["posit_codec"])
            diffs = self.static_diffs(run, pq[kind])
            if diffs:
                log(f"  {arch} {kind}: bf16-weight tokens differ from the prequantized run's: "
                    f"{diffs}")
            if any(d["plain_top2_margin"] >= E2E_LOGIT_TOL for d in diffs):
                failures.append(f"{arch} {kind}: tokens differ at a top-2 margin >= "
                                f"{E2E_LOGIT_TOL}: {diffs}")
            res[f"bf16_{kind}_diffs"] = diffs
        profile_bf16 = self.static_profile(eng, short)
        del eng

        # 3. mamba2 under its config's own numerics (posit_quant: K3's
        # quantize on both operands of every projection, an f32 matmul),
        # on bf16 weights and then on prequantized ones
        if cfg.family == "ssm":
            from repro_torch.kernels.posit_codec import quantize_table
            from repro_torch.numerics import P16

            quantize_table(P16, self.dev)  # built once, outside the gated runs
            qcfg = cfg.with_numerics(native)
            eng = Engine(qcfg, params=model, device=self.dev)
            run = self.static_run(f"{arch} {qcfg.numerics.mode}:16:1", eng, short, STATIC_NEW)
            failures.extend(f"{arch} posit_quant: {f}" for f in self.static_gates(run, 0, 2 * k1))
            self.path_launches["posit_codec"] = (self.path_launches.get("posit_codec", 0)
                                                 + run["launches"]["posit_codec"])
            res["posit_quant"] = run_summary(run)
            del eng
            res["posit_quant_prequantized"] = self.static_posit_quant_prequantized(
                qcfg, model, short, run, k1, failures)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        res.update({
            "params": n_params, "init_s": init_s, "encodes_at_build": encodes,
            "int16_weight_gb": int16_gb, "decode_extension_max_err": ext,
            "decode_extension_mean_err": mean_ext, "chunk_order_max_diff": chunked,
            "decode_profile": profile, "decode_profile_bf16": profile_bf16,
            **{f"prequantized_{k}": run_summary(v) for k, v in pq.items()},
            **{f"bf16_{k}": run_summary(v) for k, v in bf.items()}})
        return res

    def static_posit_quant_prequantized(self, qcfg, model, prompts, want, k1, failures):
        """``model`` (bf16 weights) prequantized in place under its own
        posit_quant policy and served on ``prompts``: each forward decodes
        its k1 int16 weights with K3 (core/modes.py::_pattern_matmul) and
        quantizes the k1 activations with K3, no plain codec call on the
        card, and the greedy tokens of ``want``, the same numerics on the
        bf16 weights (decode . encode of a bf16 weight is its quantize)."""
        from repro_torch.core.prequant import quantize_params
        from repro_torch.kernels import _lib
        from repro_torch.serving import Engine

        arch = qcfg.name
        _lib.reset_launches()
        _, meta = quantize_params(qcfg, model)
        encodes = _lib.launches["posit_codec"]
        self.path_launches["posit_codec"] = self.path_launches.get("posit_codec", 0) + encodes
        if encodes != launch_counts(qcfg)["build"]:
            failures.append(f"{arch} posit_quant prequantized: {encodes} weight encodes at "
                            f"build, {len(meta)} sites")
        eng = Engine(qcfg, params=model, device=self.dev)
        with self.recording_k3("posit_decode") as decodes, self.recording_k3() as quants, \
                self.counting_codec() as codec, self.counting_plain() as plain:
            run = self.static_run(f"{arch} posit_quant:16:1 prequantized", eng, prompts,
                                  STATIC_NEW)
        del eng
        forwards = len(run["calls"])
        # each (shape, dtype) K3 decoded or quantized, bit for bit against the
        # plain version at its first launch, and a decode step's calls
        # against K3_STEP_CALLS (the calls phase times sums)
        recorded = {"decode": decodes, "quantize": quants}
        wrong = {f"{op} {rec['shape']} {rec['dtype']}": rec["lanes_differ"]
                 for op, seen in recorded.items() for rec in seen.values() if rec["lanes_differ"]}
        if wrong:
            failures.append(f"{arch} posit_quant prequantized: K3 lanes that differ from the "
                            f"plain version {wrong}")
        steps = sum(kind == "decode" for kind, _, _ in run["calls"])
        step_calls = {}
        for op, shape, kind, per_step, per_prefill in K3_STEP_CALLS:
            rec = recorded[op].get((tuple(shape), {"bf16": "bfloat16"}.get(kind, kind)))
            got = 0 if rec is None else rec["launches"]
            expect = per_step * steps + per_prefill * (forwards - steps)
            step_calls[f"{op} {list(shape)} {kind}"] = got
            if got != expect:
                failures.append(f"{arch} posit_quant prequantized: {got} K3 {op} calls at "
                                f"{list(shape)} {kind}, K3_STEP_CALLS says {expect} ({per_step} "
                                f"a decode step, {per_prefill} a prefill)")
        seen = {op: [(r["shape"], r["dtype"], r["launches"]) for r in rec.values()]
                for op, rec in recorded.items()}
        log(f"  {arch} posit_quant prequantized: K3 (shape, dtype, launches), each bit for bit "
            f"at its first launch: {seen}; lanes that differ {wrong or 0}")
        failures.extend(f"{arch} posit_quant prequantized: {f}"
                        for f in self.static_gates(run, 0, 2 * k1))
        self.path_launches["posit_codec"] = (self.path_launches.get("posit_codec", 0)
                                             + run["launches"]["posit_codec"])
        if codec != {"posit_decode": k1 * forwards, "posit_quantize": k1 * forwards}:
            failures.append(f"{arch} posit_quant prequantized: K3 calls {codec} over "
                            f"{forwards} forwards, expected {k1} decodes and {k1} quantizes each")
        if any(plain.values()):
            failures.append(f"{arch} posit_quant prequantized: plain calls on the card {plain}")
        same = run["outputs"] == want["outputs"]
        if not same:
            failures.append(f"{arch} posit_quant prequantized: greedy tokens differ from the "
                            f"bf16-weight run's: {self.static_diffs(run, want)}")
        log(f"  {arch} posit_quant:16:1 on prequantized weights: {encodes} encodes at build, "
            f"{len(meta)} sites; K3 per forward {codec['posit_decode'] // max(forwards, 1)} "
            f"decodes and {codec['posit_quantize'] // max(forwards, 1)} quantizes over "
            f"{forwards} forwards; plain calls on the card {plain}; greedy tokens "
            f"{'equal to' if same else 'DIFFER from'} the bf16-weight run's")
        return {**run_summary(run), "encodes_at_build": encodes, "codec_calls": codec,
                "plain_calls": plain, "tokens_equal": same,
                "k3_recorded": {op: list(seen.values()) for op, seen in recorded.items()},
                "k3_step_calls": step_calls}

    def static_yi(self, failures):
        """yi-6b at full width cut to STATIC_YI_LAYERS layers, prequantized,
        on the static engine against the continuous engine on the same
        prompts; then a DraftModelDrafter (a STATIC_DRAFT_LAYERS-layer draft
        of its widths, its own seeded weights, kept bf16) drafting
        STATIC_SPEC_K tokens for it on the continuous engine.  Each run's
        tokens equal the continuous plain run's, or differ only where the
        plain context's top-2 margin is below E2E_LOGIT_TOL."""
        torch = self.torch
        import gc

        from repro_torch.core.prequant import quantize_params
        from repro_torch.models import transformer as tf
        from repro_torch.serving import DraftModelDrafter, Engine, ServeOptions

        layers = min(self.args.layers, STATIC_YI_LAYERS)
        cfg = self.yi_cfg(layers)
        model = tf.lm_init(cfg, seed=0, device=self.dev)
        quantize_params(cfg, model)
        prompts = self.static_prompts(cfg.vocab, STATIC_BATCH, STATIC_PROMPT, 19)
        eng = Engine(cfg, params=model, device=self.dev)
        static = self.static_run(f"yi-6b ({layers} layers) static", eng, prompts, STATIC_NEW)
        del eng
        failures.extend(f"yi-6b static: {f}"
                        for f in self.static_gates(static, launch_counts(cfg)["k1"], 0))
        self.path_launches["plam_matmul"] = (self.path_launches.get("plam_matmul", 0)
                                             + static["launches"]["plam_matmul"])
        opts = ServeOptions(max_new_tokens=STATIC_NEW, block_size=16, max_slots=4, num_blocks=64,
                            max_seq_len=128)
        rows = prompts.tolist()
        plain = self.serve_run(f"yi-6b ({layers} layers) continuous", cfg, model, opts, rows)
        res = {"layers": layers, "static": run_summary(static),
               "continuous_outputs": plain["outputs"]}
        diffs = self.token_diffs(cfg, model, rows, static["outputs"], plain["outputs"])
        res["static_diffs"] = diffs
        log(f"  yi-6b static tokens {'equal to' if not diffs else 'differ from'} the "
            f"continuous engine's" + (f": {diffs}" if diffs else ""))
        if any(d["plain_top2_margin"] >= E2E_LOGIT_TOL for d in diffs):
            failures.append(f"yi-6b static: tokens differ at a top-2 margin >= "
                            f"{E2E_LOGIT_TOL}: {diffs}")
        draft_cfg = dataclasses.replace(cfg, n_layers=STATIC_DRAFT_LAYERS)
        drafter = DraftModelDrafter(draft_cfg, cfg, init_seed=1, device=self.dev)
        spec = self.serve_run(
            f"yi-6b spec_k={STATIC_SPEC_K}, a {STATIC_DRAFT_LAYERS}-layer draft model", cfg,
            model, dataclasses.replace(opts, spec_k=STATIC_SPEC_K, spec_draft=drafter), rows)
        diffs = self.token_diffs(cfg, model, rows, spec["outputs"], plain["outputs"])
        log(f"  draft model: {drafter.proposals} proposals, {drafter.proposed_tokens} tokens "
            f"proposed; acceptance {spec['acceptance_rate']:.3f}, "
            f"{spec['tokens_per_verify_step']:.2f} tokens a verify step over "
            f"{spec['spec_steps']} verify steps; committed tokens "
            f"{'equal to' if not diffs else 'differ from'} the spec_k=0 run's"
            + (f": {diffs}" if diffs else ""))
        if any(d["plain_top2_margin"] >= E2E_LOGIT_TOL for d in diffs):
            failures.append(f"draft model: tokens differ at a top-2 margin >= {E2E_LOGIT_TOL}: "
                            f"{diffs}")
        if drafter.proposals == 0:
            failures.append("draft model: no proposal")
        res["draft"] = {"proposals": drafter.proposals,
                        "proposed_tokens": drafter.proposed_tokens,
                        "acceptance_rate": spec["acceptance_rate"],
                        "tokens_per_verify_step": spec["tokens_per_verify_step"],
                        "spec_steps": spec["spec_steps"], "wall_s": spec["wall_s"],
                        "diffs": diffs}
        del model, drafter
        gc.collect()
        torch.cuda.empty_cache()
        return res

    def static_cli(self, failures):
        """``python -m repro_torch.launch.serve`` without --continuous (the
        static engine) on full-width mamba2-780m, prequantized."""
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"] + STATIC_CLI,
                              cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=STATIC_CLI_TIMEOUT_S)
        secs = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        summary = lines[0] if lines else ""
        rows = [ln for ln in lines if ln.startswith("batch[")]
        log(f"  static serve CLI ({secs:.1f} s, exit {proc.returncode}): "
            f"{summary or proc.stderr.strip().splitlines()[-3:]}")
        if (proc.returncode != 0 or len(rows) != 4
                or not summary.startswith("arch=mamba2-780m numerics='default=plam_sim:16:1'")):
            failures.append(f"static CLI: exit {proc.returncode}, {len(rows)} batch rows")
        return {"argv": STATIC_CLI, "rc": proc.returncode, "seconds": secs, "stdout": lines[:8]}

    def phase_static(self):
        """The static engine and the state-space families at full width and
        depth: mamba2-780m and zamba2-1.2b (static_model), yi-6b on the
        static engine and a draft model drafting for it (static_yi), and
        the serving CLI without --continuous.  Every K1 launch of the two
        state-space models is held, after their runs, to the plain version
        on the first launch's own operands at each shape; no plain K1 or
        codec call runs on the card."""
        torch = self.torch
        import gc

        self.yi_model = None  # the earlier phases' model
        gc.collect()
        torch.cuda.empty_cache()
        failures, res = [], {}
        t0 = time.perf_counter()
        for arch in STATIC_ARCHS:
            with self.recording_k1() as seen, self.counting_plain() as plain:
                res[arch] = self.static_model(arch, failures)
            if any(plain.values()):
                failures.append(f"{arch}: plain calls on the card {plain}")
            log(f"  {arch}: plain K1 / codec calls on the card {plain}")
            res[arch]["k1_checked"] = self.check_recorded_k1(arch, seen, failures)
            res[arch]["k1_times"] = self.static_k1_times(arch)
        with self.counting_plain() as plain:
            res["yi-6b"] = self.static_yi(failures)
        if any(plain.values()):
            failures.append(f"yi-6b / draft: plain calls on the card {plain}")
        res["cli"] = self.static_cli(failures)
        res["seconds"] = time.perf_counter() - t0
        self.results["static"] = res
        if failures:
            raise AssertionError("; ".join(failures[:8]))

    # -- phase archs -----------------------------------------------------------

    def archs_cfg(self, arch):
        """``arch`` under default=plam_sim:16:1, cut to ARCHS_LAYERS (or
        --layers, if fewer) where the card cannot hold it whole."""
        from repro_torch.configs import get_config

        cfg = get_config(arch).with_numerics("default=plam_sim:16:1")
        if arch in ARCHS_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=min(ARCHS_LAYERS[arch], self.args.layers))
        return cfg

    def archs_inputs(self, cfg, seed):
        """The static prompt batch of ``cfg``'s family: int32 tokens [B, S]
        and, on the card, the seeded stub-frontend inputs (bf16)."""
        import numpy as np

        from repro_torch.models.registry import vlm_patches

        rng = np.random.default_rng(seed)
        if cfg.family == "encdec":
            tokens = rng.integers(0, cfg.vocab, (ARCHS_BATCH, ARCHS_TGT))
            frames = rng.standard_normal((ARCHS_BATCH, ARCHS_FRAMES, cfg.frontend_dim))
            extra = {"frames": frames}
        elif cfg.family == "vlm":
            tokens = rng.integers(0, cfg.vocab, (VLM_ROWS, VLM_TOKENS))
            extra = {"embeds_prefix": rng.standard_normal((VLM_ROWS, vlm_patches(cfg),
                                                           cfg.d_model))}
        else:
            tokens = rng.integers(0, cfg.vocab, (ARCHS_BATCH, ARCHS_PROMPT))
            extra = {}
        extra = {k: self.torch.from_numpy(v.astype(np.float32)).to(self.dev, self.torch.bfloat16)
                 for k, v in extra.items()}
        return self.torch.from_numpy(tokens.astype(np.int32)), extra

    @contextlib.contextmanager
    def recording_k1_rows(self, params):
        """The first K1 launch over float activations at each (A shape and
        dtype, B shape and dtype, spec) while the block runs, kept for
        check_recorded_rows: A's first K1_ROWS rows and its last 64-row
        block, and the same rows of the output; B whole where it is one of
        ``params`` (the model's weights, held by the model), else (made in
        the forward) its first and last K1_COLS columns, with the same
        columns of the output."""
        torch = self.torch
        from repro_torch.kernels import ops

        real, seen = ops.plam_matmul_float, {}
        held = {p.data_ptr() for p in params}

        def recorded(x, b, spec, **kw):
            out = real(x, b, spec, **kw)
            key = (tuple(x.shape), str(x.dtype)[6:], tuple(b.shape), str(b.dtype)[6:],
                   (spec.n, spec.es))
            if key not in seen and x.is_cuda and x.dim() == 2:
                m, n = x.shape[0], b.shape[-1]
                tail = max(K1_ROWS, (m - 1) // 64 * 64)
                rows = torch.cat([torch.arange(min(m, K1_ROWS)), torch.arange(tail, max(tail, m))])
                rows = rows.to(self.dev)
                if b.data_ptr() in held or n <= 2 * K1_COLS:
                    cols, bk = None, b
                else:
                    cols = torch.cat([torch.arange(K1_COLS),
                                      torch.arange(n - K1_COLS, n)]).to(self.dev)
                    bk = b[:, cols].clone()
                got = out[rows] if cols is None else out[rows][:, cols]
                seen[key] = [x[rows].clone(), bk, spec, got.clone(), 0, m, cols is not None]
            if key in seen:
                seen[key][4] += 1
            return out

        ops.plam_matmul_float = recorded
        try:
            yield seen
        finally:
            ops.plam_matmul_float = real

    def check_recorded_rows(self, what, seen, failures) -> dict:
        """Each launch that recording_k1_rows kept against K1's plain version
        on the same rows (and columns) of its operands, bit for bit.  No
        kernel is launched here."""
        torch = self.torch
        from repro_torch.kernels.plam_matmul import plam_matmul_float

        n_before, t0, cases = len(failures), time.perf_counter(), []
        for key in sorted(seen, key=lambda k: (k[2][-1], k[0][0])):
            x, b, spec, got, calls, m, windowed = seen[key]
            k, n = x.shape[1], key[2][-1]
            want = plam_matmul_float(x, b, spec, use_kernel=False)
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            if bad:
                failures.append(f"{what}: K1 M={m} K={k} N={n} A={key[1]} B={key[3]}: "
                                f"{bad} lanes differ from the plain version")
            cases.append({"m": m, "k": k, "n": n, "a": key[1], "b": key[3], "launches": calls,
                          "rows_checked": x.shape[0], "cols_checked": b.shape[-1],
                          "lanes_differ": bad})
            del want
        seen.clear()
        torch.cuda.synchronize()
        ok = len(failures) == n_before
        secs = time.perf_counter() - t0
        log(f"  {what}: K1 at the {len(cases)} (M, K, N, A, B) it was launched with, each "
            f"first launch's output against the plain version on its operands (rows, cols "
            f"checked): {'bit-identical' if ok else failures[n_before:]} in {secs:.1f} s: "
            + str([(c["m"], c["k"], c["n"], c["b"], c["launches"], c["rows_checked"],
                    c["cols_checked"]) for c in cases]))
        return {"ok": ok, "cases": cases, "seconds": secs}

    @contextlib.contextmanager
    def recording_k2(self):
        """The first K2 call at each (B, H, kv, hd, dtype) while the block
        runs: copies of its operands and output."""
        import importlib

        # the module (the package's name of the same spelling is its K5 wrapper)
        k2_mod = importlib.import_module("repro_torch.kernels.decode_attention")
        real, seen = k2_mod.paged_decode_attention, {}

        def recorded(q, k_pool, v_pool, block_tables, lengths, **kw):
            out = real(q, k_pool, v_pool, block_tables, lengths, **kw)
            key = (*q.shape, k_pool.shape[2], str(q.dtype)[6:])
            if key not in seen and q.is_cuda:
                seen[key] = [t.clone() for t in (q, k_pool, v_pool, block_tables, lengths, out)]
            return out

        k2_mod.paged_decode_attention = recorded
        try:
            yield seen
        finally:
            k2_mod.paged_decode_attention = real

    def check_k2(self, what, seen, failures) -> list:
        """Each recorded K2 call against its plain version's f32 result on
        the same operands (K5's gates, as phase kernels' canaries), then
        timed on them beside its bytes bound and scaled_dot_product_attention
        over the same keys laid out contiguous."""
        torch = self.torch
        from repro_torch.kernels.decode_attention import (
            paged_decode_attention_kernel,
            paged_decode_attention_ref,
        )

        rows = []
        for key, (q, kp, vp, tables, lens, got) in seen.items():
            b, h, hd = q.shape
            kv = kp.shape[2]
            ref32 = paged_decode_attention_ref(q.float(), kp.float(), vp.float(), tables, lens)
            if got.dtype == torch.float32:
                gate, tol = float((got - ref32).abs().max()), K5_TOL_F32
            else:
                gate = float(((got.float() - ref32).abs() - K5_BF16_REL * ref32.abs()).max())
                tol = K5_BF16_ORDER
            err = float((got.float() - ref32).abs().max())
            if not gate <= tol:
                failures.append(f"{what}: K2 B={b} H={h} kv={kv} hd={hd}: gate {gate:.3e} > {tol}")
            ms, dev_ms = self.timed(
                lambda: paged_decode_attention_kernel(q, kp, vp, tables, lens), reps=20)
            live = int(lens.sum())
            bs = kp.shape[1]
            idx = torch.cat([tables[i, :-(-int(n) // bs)].long() for i, n in enumerate(lens)])
            s_max = max(1, int(lens.max()))
            kc = torch.zeros((b, kv, s_max, hd), dtype=kp.dtype, device=self.dev)
            vc = torch.zeros_like(kc)
            pos = 0
            for i, n in enumerate(lens.tolist()):
                nb = -(-n // bs)
                blocks = idx[pos:pos + nb]
                kc[i, :, :n] = kp[blocks].reshape(-1, kv, hd)[:n].transpose(0, 1)
                vc[i, :, :n] = vp[blocks].reshape(-1, kv, hd)[:n].transpose(0, 1)
                pos += nb
            lib_ms = self.events_ms(self.sdpa(q, kc, vc, lens), reps=20, spin=True)
            bytes_ = 2 * q.numel() * q.element_size() + 2 * live * kv * hd * kp.element_size()
            bound = bytes_ / HBM_BYTES_PER_S * 1e3
            rows.append({"b": b, "h": h, "kv": kv, "group": h // kv, "hd": hd,
                         "lengths": lens.tolist(), "max_abs_err": err, "k5_gate": gate,
                         "ms": ms, "device_ms": dev_ms, "bound_ms": bound, "library_ms": lib_ms})
            log(f"  {what}: K2 B={b} H={h} kv={kv} (group {h // kv}) hd={hd} lens "
                f"{lens.tolist()}: max_abs_err {err:.3e} against the plain version (K5 gate "
                f"{gate:.3e}, tol {tol}); {ms:.4f} ms, device {dev_ms:.4f} ms against a bytes "
                f"bound of {bound:.4f} ms ({dev_ms / bound:.1f}x), SDPA {lib_ms:.4f} ms device")
        seen.clear()
        return rows

    def archs_k1_times(self, cfg, ms_list):
        """K1 over bf16 activations and int16 weights at each (K, N) of
        ``cfg``'s projections, at each M of ``ms_list``, spun (the card's
        time), beside its bound (bytes: A, B and C once each; operations:
        one integer add a product at the int32 rate)."""
        torch = self.torch
        from repro_torch.kernels.ops import plam_dense
        from repro_torch.kernels.posit_codec import posit_encode
        from repro_torch.numerics import P16

        d, q, kvw = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv * cfg.hd
        shapes = [(d, q), (d, kvw), (q, d), (d, cfg.d_ff), (cfg.d_ff, d), (d, cfg.vocab)]
        if cfg.frontend_dim and cfg.family == "encdec":
            shapes.insert(0, (cfg.frontend_dim, d))
        g, rows, int_rate = self.gen(37), [], self.int32_ops_per_s()
        for k, n in dict.fromkeys(shapes):
            b = posit_encode(torch.randn((k, n), generator=g, device=self.dev) * k ** -0.5,
                             P16, out_dtype=torch.int16)
            for m in ms_list:
                x = torch.randn((m, k), generator=g, device=self.dev).to(torch.bfloat16)
                dev_ms = self.events_ms(lambda: plam_dense(x, b, P16), reps=3, spin=True)
                t_bytes = (m * k * 2 + k * n * 2 + m * n * 4) / HBM_BYTES_PER_S * 1e3
                t_ops = m * k * n / int_rate * 1e3
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                rows.append({"m": m, "k": k, "n": n, "device_ms": dev_ms, "bound_ms": bound,
                             "bound_by": by})
                del x
            del b
        log(f"  K1 times (M, K, N: device ms / bound ms by): " + "; ".join(
            f"{r['m']},{r['k']},{r['n']}: {r['device_ms']:.4f}/{r['bound_ms']:.4f} "
            f"{r['bound_by'][0]} ({r['device_ms'] / r['bound_ms']:.1f}x)" for r in rows))
        return rows

    def archs_e2e(self, arch, failures):
        """``arch`` at ARCHS_E2E_LAYERS layers (both stacks for the encdec),
        prequantized, on the static engine: a prefill and a decode step on
        the kernels and on the plain versions; the decode step's logits
        within E2E_LOGIT_TOL (phase e2e's rule).  The inputs are short, and
        there is one decode step: the plain K1 walks k in order on the card,
        ~6 launches a k, for every (K, N) of the forward."""
        torch = self.torch
        import gc

        from repro_torch.kernels import ref as k1_ref
        from repro_torch.serving import Engine, ServeConfig

        cfg = self.archs_cfg(arch)
        cut = ARCHS_E2E_LAYERS
        cfg = dataclasses.replace(cfg, n_layers=cut, enc_layers=min(cfg.enc_layers, cut),
                                  dec_layers=min(cfg.dec_layers, cut))
        tokens, extra = self.archs_inputs(cfg, 23)
        tokens = tokens[:1, :16]
        extra = {k: v[:1, :32] for k, v in extra.items()}  # 32 frames or patches
        eng = Engine(cfg, prequantize=True, init_seed=1, device=self.dev)
        outs = {}
        # the plain K1 walks k once a column slice: wider slices (2 GB int64
        # temporaries), now that the card holds only the 2-layer model
        plain_lanes, k1_ref.PLAIN_LANES = k1_ref.PLAIN_LANES, 1 << 28
        try:
            for use_kernel in (None, False):
                last = []
                decode = eng.api.decode_step

                def kept(model, batch, use_kernel=None, _decode=decode, _last=last):
                    logits, caches = _decode(model, batch, use_kernel=use_kernel)
                    _last[:] = [logits[:, -1].float()]
                    return logits, caches

                eng.use_kernel = use_kernel
                eng.api = dataclasses.replace(eng.api, decode_step=kept)
                toks = eng.generate({"tokens": tokens.to(self.dev), **extra},
                                    ServeConfig(max_new_tokens=2))
                eng.api = dataclasses.replace(eng.api, decode_step=decode)
                outs[use_kernel] = (last[0], toks[0].tolist())
        finally:
            k1_ref.PLAIN_LANES = plain_lanes
        got, want = outs[None][0], outs[False][0]
        err = float((got - want).abs().max())
        finite = bool(torch.isfinite(got).all())
        log(f"  {arch} at {cut} layers: last-logit max_abs_err {err:.3e} kernels against plain "
            f"(tol {E2E_LOGIT_TOL}, |logits| max {float(want.abs().max()):.2f}); tokens "
            f"{outs[None][1]} against {outs[False][1]}")
        if not (finite and err <= E2E_LOGIT_TOL):
            failures.append(f"{arch} e2e at {cut} layers: err {err}, finite {finite}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return {"layers": cut, "max_abs_err": err, "tokens": outs[None][1],
                "plain_tokens": outs[False][1]}

    def archs_dense(self, arch, failures):
        """One dense arch under default=plam_sim:16:1 from the port's seeded
        init, prequantized in place: the continuous engine's run (4
        requests one step apart), then (gemma, minitron) the static engine
        on the same prompts, the continuous engine with bf16 weights
        encoded every forward (gemma), two profiled decode steps, and K2
        held and timed on the first decode step's own operands."""
        torch = self.torch
        import gc

        from repro_torch.core.prequant import quantize_params
        from repro_torch.kernels import _lib
        from repro_torch.models import transformer as tf
        from repro_torch.serving import Engine, ServeOptions, build_engine

        cfg = self.archs_cfg(arch)
        counts = launch_counts(cfg)
        log(f"archs: {arch} d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv} hd {cfg.hd} "
            f"d_ff {cfg.d_ff} ({cfg.act}{', gated' if cfg.glu else ''}) vocab {cfg.vocab} "
            f"layers {cfg.n_layers}{' (cut)' if arch in ARCHS_LAYERS else ''}"
            f"{', tied head' if cfg.tie_embeddings else ''}; {counts['k1']} K1 and "
            f"{counts['k3']} K3 a forward")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = tf.lm_init(cfg, seed=0, device=self.dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        _lib.reset_launches()
        quantize_params(cfg, model)
        torch.cuda.synchronize()
        encodes = _lib.launches["posit_codec"]
        gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
        log(f"  seeded init {init_s:.1f} s: {n_params / 1e9:.3f} G parameters; "
            f"{encodes} weight encodes, {gb:.2f} GB of weights, build peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if encodes != counts["build"]:
            failures.append(f"{arch}: {encodes} weight encodes at build, expected "
                            f"{counts['build']}")
        self.path_launches["posit_codec"] = self.path_launches.get("posit_codec", 0) + encodes
        prompts, _ = self.archs_inputs(cfg, 29)
        rows = prompts.tolist()
        opts = ServeOptions(max_new_tokens=ARCHS_NEW, block_size=16, max_slots=4, num_blocks=64,
                            max_seq_len=128)
        res = {"layers": cfg.n_layers, "params": n_params, "init_s": init_s,
               "weight_gb": gb, "encodes_at_build": encodes, "counts": counts}
        params = list(model.parameters())
        with self.recording_k1_rows(params) as seen, self.counting_plain() as plain:
            torch.cuda.reset_peak_memory_stats()
            cont = self.serve_run(f"  {arch} continuous", cfg, model, opts, rows)
            cont["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            per_request = cont["prefill_s"] / cont["prefills"]
            log(f"  {arch} continuous: step p50 {cont['step_p50_s'] * 1e3:.2f} ms, p95 "
                f"{cont['step_p95_s'] * 1e3:.2f} ms, prefill {per_request:.3f} s a request, "
                f"peak {cont['peak_gib']:.2f} GiB")
            failures.extend(f"{arch} continuous: {f}"
                            for f in self.forward_gates(cont, cfg.n_layers, counts))
            for name in ("plam_matmul", "paged_decode_attention", "posit_codec"):
                self.path_launches[name] = (self.path_launches.get(name, 0)
                                            + cont["launches"][name])
            res["continuous"] = run_summary(cont)
            if arch in ARCHS_BOTH_ENGINES:
                eng = Engine(cfg, params=model, device=self.dev)
                static = self.static_run(f"{arch} static", eng, prompts, ARCHS_NEW)
                del eng
                failures.extend(f"{arch} static: {f}"
                                for f in self.static_gates(static, counts["k1"], counts["k3"]))
                self.path_launches["plam_matmul"] = (self.path_launches.get("plam_matmul", 0)
                                                     + static["launches"]["plam_matmul"])
                diffs = self.token_diffs(cfg, model, rows, static["outputs"], cont["outputs"])
                log(f"  {arch} static tokens {'equal to' if not diffs else 'differ from'} the "
                    f"continuous engine's" + (f": {diffs}" if diffs else ""))
                if any(d["plain_top2_margin"] >= E2E_LOGIT_TOL for d in diffs):
                    failures.append(f"{arch} static: tokens differ at a top-2 margin >= "
                                    f"{E2E_LOGIT_TOL}: {diffs}")
                res["static"] = run_summary(static)
                res["static_diffs"] = diffs
        if any(plain.values()):
            failures.append(f"{arch}: plain calls on the card {plain}")
        log(f"  {arch}: plain K1 / codec calls on the card {plain}")
        res["k1_checked"] = self.check_recorded_rows(arch, seen, failures)
        # two profiled decode steps; K2 kept on the first decode step with
        # all four slots busy (the profile's first step), then held and timed
        eng = build_engine(cfg, opts, params=model)
        with self.recording_k2() as k2_seen:
            res["decode_profile"], _ = self.profile_decode(eng, rows)
        res["k2"] = self.check_k2(arch, k2_seen, failures)
        del eng, params
        del model
        gc.collect()
        torch.cuda.empty_cache()
        if arch == "gemma-7b":  # bf16 weights, encoded by K3 before each K1 launch
            model = tf.lm_init(cfg, seed=0, device=self.dev)
            bf_counts = launch_counts(cfg, prequantized=False)
            with self.counting_plain() as plain:
                bf = self.serve_run(f"  {arch} bf16 weights", cfg, model, opts, rows)
            failures.extend(f"{arch} bf16: {f}"
                            for f in self.forward_gates(bf, cfg.n_layers, bf_counts))
            if any(plain.values()):
                failures.append(f"{arch} bf16: plain calls on the card {plain}")
            self.path_launches["posit_codec"] = (self.path_launches.get("posit_codec", 0)
                                                 + bf["launches"]["posit_codec"])
            same = bf["outputs"] == cont["outputs"]
            log(f"  {arch} bf16-weight tokens {'equal to' if same else 'DIFFER from'} the "
                f"prequantized run's")
            if not same:
                failures.append(f"{arch}: bf16-weight tokens differ from the prequantized run's")
            res["bf16"] = run_summary(bf)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        res["k1_times"] = self.archs_k1_times(
            cfg, (4, ARCHS_BATCH * ARCHS_PROMPT if arch in ARCHS_BOTH_ENGINES else ARCHS_PROMPT))
        res["e2e"] = self.archs_e2e(arch, failures)
        return res

    def archs_static(self, arch, failures):
        """seamless-m4t-medium or qwen2-vl-72b on the static engine under
        default=plam_sim:16:1 from the port's seeded init, prequantized:
        its prompt batch with the stub frontend's seeded inputs, every
        forward's launches, the first decode step against a prefill of one
        more token, two profiled decode steps; seamless also under its
        config's own posit_quant:16:1 on its bf16 weights."""
        torch = self.torch
        import gc

        from repro_torch.core.prequant import quantize_params
        from repro_torch.kernels import _lib
        from repro_torch.models import build
        from repro_torch.serving import Engine

        cfg = self.archs_cfg(arch)
        counts = launch_counts(cfg)
        enc = cfg.family == "encdec"
        log(f"archs: {arch} family {cfg.family} d_model {cfg.d_model} heads "
            f"{cfg.n_heads}/{cfg.n_kv} hd {cfg.hd} d_ff {cfg.d_ff} vocab {cfg.vocab} layers "
            + (f"{cfg.enc_layers} + {cfg.dec_layers}, frontend {cfg.frontend_dim}" if enc else
               f"{cfg.n_layers} (cut), M-RoPE sections {cfg.mrope_sections}")
            + f"; {counts['enc_k1'] + counts['k1']} K1 a prefill, {counts['k1']} a decode step")
        api = build(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = api.init(seed=0, device=self.dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        bf_model = None
        _lib.reset_launches()
        quantize_params(cfg, model)
        torch.cuda.synchronize()
        encodes = _lib.launches["posit_codec"]
        gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
        log(f"  seeded init {init_s:.1f} s: {n_params / 1e9:.3f} G parameters; {encodes} "
            f"weight encodes, {gb:.2f} GB of weights")
        if encodes != counts["build"]:
            failures.append(f"{arch}: {encodes} weight encodes at build, expected "
                            f"{counts['build']}")
        self.path_launches["posit_codec"] = self.path_launches.get("posit_codec", 0) + encodes
        tokens, extra = self.archs_inputs(cfg, 31)
        res = {"layers": cfg.n_layers, "params": n_params, "init_s": init_s, "weight_gb": gb,
               "encodes_at_build": encodes, "counts": counts}
        params = list(model.parameters())
        with self.recording_k1_rows(params) as seen, self.counting_plain() as plain:
            eng = Engine(cfg, params=model, device=self.dev)
            run = self.static_run(f"{arch} prequantized", eng, tokens, ARCHS_NEW, extra)
            prefill = (counts["enc_k1"] + counts["k1"], 0)
            failures.extend(f"{arch}: {f}" for f in self.static_gates(
                run, counts["k1"], 0, prefill=prefill, outside=(counts["enc_k1"], 0)))
            self.path_launches["plam_matmul"] = (self.path_launches.get("plam_matmul", 0)
                                                 + run["launches"]["plam_matmul"])
            # the first decode step against a prefill of the prompt and its
            # first token (whose caches the profile then decodes from)
            ext_tokens = torch.cat([tokens.to(self.dev),
                                    torch.tensor(run["outputs"], device=self.dev)[:, :1]],
                                   dim=1).to(torch.int32)
            prefilled = api.prefill(model, {"tokens": ext_tokens, **extra})
            ext = float((run["first_decode"] - prefilled[0][:, -1].float()).abs().max())
            res.update(prequantized=run_summary(run), decode_extension_bf16_max_err=ext)
        if any(plain.values()):
            failures.append(f"{arch}: plain calls on the card {plain}")
        log(f"  {arch}: plain K1 / codec calls on the card {plain}")
        ext32, off = self.archs_extension_f32(cfg, model, ext_tokens, extra)
        log(f"  {arch}: the first decode step against a prefill of one more token, max |logit "
            f"difference|: {ext:.4f} with bf16 activations (served; not gated), {ext32:.4f} "
            f"with f32 activations (tolerance {E2E_LOGIT_TOL})"
            + (f"; a decode one patch prefix off: {off:.4f}" if off is not None else ""))
        if not ext32 <= E2E_LOGIT_TOL:
            failures.append(f"{arch}: decode after prefill {ext32:.4f} from the prefill "
                            f"extension (f32 activations)")
        res.update(decode_extension_max_err=ext32, decode_off_by_patches_max_err=off)
        res["k1_checked"] = self.check_recorded_rows(arch, seen, failures)
        res["decode_profile"] = self.static_profile(eng, ext_tokens, extra, prefilled)
        del eng, params, model, prefilled
        gc.collect()
        torch.cuda.empty_cache()
        if enc:  # the config's own numerics on bf16 weights: K3 quantizes both operands
            from repro_torch.configs import get_config
            from repro_torch.kernels.posit_codec import quantize_table
            from repro_torch.numerics import P16

            quantize_table(P16, self.dev)  # built once, outside the gated run
            qcfg = cfg.with_numerics(get_config(arch).numerics)
            bf_model = build(qcfg).init(seed=0, device=self.dev)
            eng = Engine(qcfg, params=bf_model, device=self.dev)
            with self.counting_plain() as plain:
                run = self.static_run(f"{arch} {qcfg.numerics.mode}:16:1", eng, tokens,
                                      ARCHS_NEW, extra)
            q = {k: 2 * v for k, v in counts.items()}
            failures.extend(f"{arch} posit_quant: {f}" for f in self.static_gates(
                run, 0, q["k1"], prefill=(0, q["enc_k1"] + q["k1"]), outside=(0, q["enc_k1"])))
            if any(plain.values()):
                failures.append(f"{arch} posit_quant: plain calls on the card {plain}")
            self.path_launches["posit_codec"] = (self.path_launches.get("posit_codec", 0)
                                                 + run["launches"]["posit_codec"])
            res["posit_quant"] = run_summary(run)
            del eng, bf_model
            gc.collect()
            torch.cuda.empty_cache()
        ms = (4, ARCHS_BATCH * ARCHS_TGT, ARCHS_BATCH * ARCHS_FRAMES) if enc else \
            (VLM_ROWS, VLM_ROWS * (tokens.shape[1] + extra["embeds_prefix"].shape[1]))
        res["k1_times"] = self.archs_k1_times(cfg, ms)
        res["e2e"] = self.archs_e2e(arch, failures)
        return res

    def archs_extension_f32(self, cfg, model, ext_tokens, extra):
        """Decode after prefill on ``model`` with f32 activations: a prefill
        of all but the last token of ``ext_tokens`` (after the stub
        frontend's inputs), the decode step of that token at its position
        (patches + tokens for the vlm), against the last logits of a
        prefill of all of ``ext_tokens``: in f32 the comparison sees the
        cache and the positions, where in bf16 it also sees the rounding of
        every activation (PERF.md).  For scale, the vlm's decode step also
        runs one patch prefix off (at the tokens' position alone), the
        error the check is for.  Returns the largest |difference| of each
        (None for the second without patches)."""
        from repro_torch.models import build
        from repro_torch.serving import Engine

        fcfg = dataclasses.replace(cfg, act_dtype="float32")
        api, eng = build(fcfg), Engine(fcfg, params=model, device=self.dev)
        extra = {k: v.float() for k, v in extra.items()}
        t = ext_tokens.shape[1] - 1
        batch = {"tokens": ext_tokens[:, :t], **extra}
        _, caches = api.prefill(model, batch)
        pos0 = t + (extra["embeds_prefix"].shape[1] if "embeds_prefix" in extra else 0)
        step = {"token": ext_tokens[:, t:], "cache_len": pos0,
                **eng._cache_kw(eng._grow_caches(caches, 2), batch)}
        got, _ = api.decode_step(model, step)
        want, _ = api.prefill(model, {"tokens": ext_tokens, **extra})
        off = None
        if "embeds_prefix" in extra:  # the prefill's caches again (a decode writes a copy)
            step = {"token": ext_tokens[:, t:], "cache_len": t,
                    "kv_caches": eng._grow_caches(caches, 2)}
            wrong, _ = api.decode_step(model, step)
            off = float((wrong[:, -1].float() - want[:, -1].float()).abs().max())
        return float((got[:, -1].float() - want[:, -1].float()).abs().max()), off

    def phase_archs(self):
        """The five architectures the earlier phases do not serve, at full
        width under default=plam_sim:16:1 through K1: gemma-7b and
        minitron-8b at full depth on both engines, command-r-plus-104b on
        the continuous engine cut in depth, seamless-m4t-medium at full
        depth and qwen2-vl-72b cut in depth on the static engine
        (archs_dense, archs_static); each also at 2 layers, kernels
        against plain versions."""
        torch = self.torch
        import gc

        self.yi_model = None  # the earlier phases' model
        gc.collect()
        torch.cuda.empty_cache()
        failures, res = [], {}
        t0 = time.perf_counter()
        for arch in ARCHS_DENSE:
            res[arch] = self.archs_dense(arch, failures)
        for arch in ARCHS_STATIC:
            res[arch] = self.archs_static(arch, failures)
        res["seconds"] = time.perf_counter() - t0
        self.results["archs"] = res
        if failures:
            raise AssertionError("; ".join(failures[:8]))

    # -- phase 9 -------------------------------------------------------------

    def train_cfg(self):
        """yi-6b at full width, as configs/yi_6b.py gives it (bf16
        parameters, remat, posit_quant:16:1), cut to TRAIN_LAYERS layers
        (or fewer with --layers)."""
        from repro_torch.configs import get_config

        cfg = get_config("yi-6b")
        return dataclasses.replace(cfg, n_layers=min(self.args.layers, TRAIN_LAYERS))

    def phase_train(self):
        """Training and the paper's Table II on the card: AdamW steps on
        full-width yi-6b under posit_quant (K3's quantize on every
        projection; family_steps, as phase train_families), the trained
        weights served under plam_sim (encoded every forward, then
        prequantized) and calibrated, the training
        CLI's fault drill, and the five Table II models trained in f32 and
        evaluated under f32, posit16 and plam16 (K3 and K1)."""
        torch = self.torch
        import gc

        from repro_torch.core.policy import describe

        self.yi_model = None  # the earlier phases' model
        gc.collect()
        torch.cuda.empty_cache()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        log(f"train: TF32 matmul allowed: {tf32}; float32 matmul precision "
            f"{torch.get_float32_matmul_precision()!r}")
        failures = [] if not tf32 else ["TF32 is on: f32 matmuls would not be f32"]
        cfg = self.train_cfg()
        log(f"train: yi-6b d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv} hd {cfg.hd} "
            f"d_ff {cfg.d_ff} vocab {cfg.vocab} layers {cfg.n_layers} of 32 (AdamW's f32 m and "
            f"v over all 32 layers' 6.06 B parameters are 48.5 GB and bf16 parameters and "
            f"gradients 24.2 GB more: no safe room on 80 GB for activations and the codec's "
            f"f32 outputs) param/act {cfg.param_dtype}/{cfg.act_dtype} remat {cfg.remat} "
            f"numerics {describe(cfg.numerics)!r}")
        res = {"tf32": tf32}
        model, res["yi"] = self.family_steps("yi-6b", cfg, TRAIN_LR, failures,
                                             phase="train", profiled=True)
        res["yi"].pop("cfg")
        gc.collect()  # AdamW's state
        torch.cuda.empty_cache()
        res["serve"] = self.serve_trained(cfg, model, failures)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        res["cli"] = self.train_cli(failures)
        res["table2"] = self.table2(failures)
        self.results["train"] = res
        if failures:
            raise AssertionError("; ".join(failures[:8]))

    def profile_train_step(self, step, model, state, batch):
        """One more training step (after the counted ones) under
        torch.profiler: wall, device busy and idle share, and device time
        by kind: f32 GEMMs (cuBLAS), K3's quantize, the rest by name."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            log("  train step profile: this torch cannot trace the card (not measured)")
            return None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(model, state, batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # the card's own events only: a host-side record (an aten op, the
        # autograd Function around K3) carries the device time of the
        # kernels it launched, which are listed on their own as well
        by_name = self.device_us_by_name(
            prof, lambda evt: evt.device_type == torch.autograd.DeviceType.CUDA)
        by_name.pop("Command Buffer Full", None)  # a launch-queue marker, no kernel
        busy = sum(by_name.values())
        if busy == 0:
            log("  train step profile: no device time recorded (not measured)")
            return None
        def is_k3(name):  # the quantize's computed and table kernels
            return "quantize_kernel" in name or "quantize_table_kernel" in name

        gemm = sum(us for n, us in by_name.items() if "gemm" in n.lower())
        k3 = sum(us for n, us in by_name.items() if is_k3(n))
        rest = sorted(((n, us) for n, us in by_name.items()
                       if "gemm" not in n.lower() and not is_k3(n)),
                      key=lambda kv: -kv[1])
        log(f"  train step profile (a step after the counted ones): wall {wall_us / 1e3:.1f} "
            f"ms, device busy {busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f}; f32 "
            f"GEMMs {gemm / 1e3:.1f} ms ({gemm / busy:.1%}), K3 quantize {k3 / 1e3:.2f} ms "
            f"({k3 / busy:.1%}), the rest {(busy - gemm - k3) / 1e3:.1f} ms; its top:")
        for name, us in rest[:6]:
            log(f"    {us / 1e3:8.2f} ms  {name[:100]}")
        return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
                "gemm_ms": gemm / 1e3, "k3_ms": k3 / 1e3,
                "rest_top": [[n, us / 1e3] for n, us in rest[:6]]}

    def serve_trained(self, cfg, model, failures):
        """The trained weights served under default=plam_sim:16:1 on the
        serve phase's requests: kept bf16 (each forward encodes them: 7L+1
        K3 and 7L+1 K1), then calibrated, then prequantized in place (7L+1
        K1, no K3); L K2 a decode step; equal greedy tokens."""
        from repro_torch.kernels.posit_codec import bf16_table
        from repro_torch.models import transformer as tf
        from repro_torch.numerics import P16
        from repro_torch.serving import ServeOptions

        layers = cfg.n_layers
        tf.set_trainable(model, False)
        scfg = cfg.with_numerics("default=plam_sim:16:1")
        _, prompts = self.moe_prompts(cfg.vocab)
        # K3's bf16 table is built once per (spec, card), counted apart: built
        # here (when phase kernels has not), so that no forward counts it
        bf16_table(P16, self.dev)
        base = ServeOptions(max_new_tokens=16, block_size=16, max_slots=4, num_blocks=64,
                            max_seq_len=128, prequantize=False)
        plain = self.serve_run("trained yi-6b, bf16 weights", scfg, model, base, prompts)
        for kind, m, got, _ in plain["calls"]:
            want = {k: 0 for k in got}
            want.update(plam_matmul=7 * layers + 1, posit_codec=7 * layers + 1,
                        paged_decode_attention=layers if kind == "decode" else 0)
            if got != want:
                failures.append(f"trained, bf16: {kind} forward at M={m}: {got}, want {want}")
                break
        cal = self.calibrate_trained(cfg, model, failures)
        quant = self.serve_run("trained yi-6b, prequantized", scfg, model,
                               dataclasses.replace(base, prequantize=True), prompts)
        failures.extend(f"trained, prequantized: {f}" for f in self.forward_gates(quant, layers))
        equal = quant["outputs"] == plain["outputs"]
        if not equal:
            failures.append("trained: greedy tokens differ between bf16 and prequantized weights")
        if not all(len(o) == 16 and all(0 <= t < cfg.vocab for t in o) for o in quant["outputs"]):
            failures.append("trained: a request did not return 16 valid tokens")
        log(f"  trained weights served: tokens {'equal' if equal else 'DIFFER'} "
            f"({quant['outputs'][0][:8]}...)")
        for run in (plain, quant):
            self.path_launches["plam_matmul"] = (self.path_launches.get("plam_matmul", 0)
                                                 + run["launches"]["plam_matmul"])
        return {"tokens_equal": equal, "calibrate": cal,
                **{name: {k: v for k, v in run.items() if k != "calls"}
                   for name, run in (("bf16", plain), ("prequantized", quant))}}

    def calibrate_trained(self, cfg, model, failures):
        """calibrate() on the trained model and the next batch, budget
        CALIBRATE_BUDGET: each trial evaluates train_loss under its policy
        (plam_sim sites through K3's encode and K1).  K1 is then held to its
        plain version at every shape the trials launched it with."""
        from repro_torch.data.synthetic import DataConfig, lm_batch
        from repro_torch.kernels import _lib
        from repro_torch.numerics.calibrate import calibrate

        dcfg = DataConfig(seed=0, vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
        _lib.reset_launches()
        with self.recording_k1() as seen:
            t0 = time.perf_counter()
            res = calibrate(cfg, model, lm_batch(dcfg, TRAIN_STEPS), budget=CALIBRATE_BUDGET)
            self.torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = dict(_lib.launches)
        log(f"  calibrate (budget {CALIBRATE_BUDGET}) in {secs:.2f} s: base f32 loss "
            f"{res.base_loss:.4f}, policy {res.policy_str!r}; K1 {launches['plam_matmul']}, "
            f"K3 {launches['posit_codec']} launches")
        for d in res.decisions:
            log(f"    {d['site']}: {d['assigned']} (trials "
                f"{[(t['cfg'], round(t['loss'], 4)) for t in d['trials']]})")
        k1 = self.check_recorded_k1("calibrate", seen, failures)
        return {"base_loss": res.base_loss, "policy": res.policy_str, "seconds": secs,
                "decisions": res.decisions, "launches": launches, "k1_checked": k1}

    def train_cli(self, failures):
        """python -m repro_torch.launch.train's fault drill on the card (a
        failure at step 5, checkpoints every 2): restarts=1, final_step=8,
        the numerics policy in the manifest; and the same run in-process
        with every step's loss logged, its resumed losses against an
        uninterrupted run's within TRAIN_RESUME_RTOL (the embedding's
        backward adds with atomics, so not bit for bit)."""
        import shutil
        import tempfile

        from repro_torch.configs import get_config
        from repro_torch.core.modes import NumericsConfig
        from repro_torch.core.policy import parse_policy
        from repro_torch.data.synthetic import DataConfig, lm_batch
        from repro_torch.models import transformer as tf
        from repro_torch.models.registry import build
        from repro_torch.optim.optimizers import OptConfig
        from repro_torch.train import checkpoint as ckpt
        from repro_torch.train.loop import FailureInjector, TrainConfig, run

        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"), prefix="train_cli_")
        try:
            d = os.path.join(tmp, "cli")
            env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
                                  "--ckpt-dir", d], cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=TRAIN_CLI_TIMEOUT_S)
            cli_s = time.perf_counter() - t0
            lines = out.stdout.strip().splitlines()
            log(f"  CLI {' '.join(TRAIN_CLI)} in {cli_s:.1f} s (rc {out.returncode}): {lines}")
            if out.returncode != 0:
                failures.append(f"train CLI: rc {out.returncode}: {out.stderr[-400:]}")
            elif lines[-1:] != ["restarts=1 final_step=8"]:
                failures.append(f"train CLI: last lines {lines[-2:]}")
            step = ckpt.latest_step(d)
            manifest = {}
            if step is not None:
                with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
                    manifest = json.load(f)
            policy = ckpt.manifest_policy(manifest) if manifest else None
            if step != 8 or policy != parse_policy(NumericsConfig(mode="posit_quant")):
                failures.append(f"train CLI: last checkpoint {step}, policy {policy}")

            cfg = dataclasses.replace(get_config("yi-6b").reduced(), param_dtype="float32",
                                      act_dtype="float32").with_numerics(
                NumericsConfig(mode="posit_quant"))
            api = build(cfg)
            dcfg = DataConfig(seed=0, vocab=cfg.vocab, seq_len=128, global_batch=8)

            def drill(name, failure):
                tcfg = TrainConfig(opt=OptConfig(name="adamw", lr=1e-3), log_every=1,
                                   ckpt_dir=os.path.join(tmp, name), ckpt_every=2,
                                   ckpt_extra=ckpt.policy_extra(cfg.numerics))
                return run(loss_fn=api.train_loss,
                           init_params_fn=lambda: tf.set_trainable(api.init(0, self.dev)),
                           batch_fn=lambda s: lm_batch(dcfg, s), tcfg=tcfg, num_steps=8,
                           failure=failure)[2]

            failed, whole = drill("failed", FailureInjector([5])), drill("whole", None)
            ref = dict(whole["history"])
            resumed = failed["history"][5:]  # steps 4-7 after the restore
            worst = max(abs(loss - ref[s]) / abs(ref[s]) for s, loss in resumed)
            log(f"  in-process drill: restarts {failed['restarts']}, resumed losses "
                f"{[(s, round(x, 5)) for s, x in resumed]} against "
                f"{[(s, round(ref[s], 5)) for s, _ in resumed]}: worst relative {worst:.2e} "
                f"(tol {TRAIN_RESUME_RTOL})")
            if failed["restarts"] != 1 or [s for s, _ in resumed] != [4, 5, 6, 7] \
                    or worst > TRAIN_RESUME_RTOL:
                failures.append(f"train drill: {failed}, uninterrupted {whole}")
            return {"cli_s": cli_s, "stdout": lines, "last_step": step,
                    "policy_in_manifest": policy is not None, "resumed": resumed,
                    "uninterrupted": whole["history"], "worst_rel": worst}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def table2(self, failures):
        """The five Table II setups at their own sizes (and the two MLP rows
        again at the reference's --quick size, beside its numbers), trained
        in f32 with the port's train_classifier and evaluated under f32,
        posit16 and plam16, top-1 and top-5; K3 and K1 launched in every
        plam16 evaluation.  The plam16 - f32 top-1 delta is printed beside
        the reference's 2-point bar, not gated (data order and init differ
        from the reference's by design).  K1 is then held to its plain
        version at every shape the evaluations launched it with."""
        torch = self.torch
        import numpy as np

        from repro_torch.core.modes import NumericsConfig
        from repro_torch.data.synthetic import classification_dataset, image_dataset
        from repro_torch.kernels import _lib
        from repro_torch.paper import models as pm

        modes = {"float32": NumericsConfig(mode="f32"),
                 "posit16": NumericsConfig(mode="posit_quant", n=16, es=1),
                 "plam16": NumericsConfig(mode="plam_sim", n=16, es=1)}
        rows = []
        with self.recording_k1() as seen:
            for name, kind, arch, targs in TABLE2_SETUPS:
                sizes = [("full", targs)]
                if name in TABLE2_REFERENCE_QUICK:
                    sizes.append(("quick", dict(targs, **TABLE2_QUICK)))
                for size, t in sizes:
                    n = t["n"]
                    if kind == "mlp":
                        x, y = classification_dataset(0, n + 1000, arch[0], arch[-1])
                        init, apply_fn = (lambda g, a=arch: pm.mlp_init(g, a)), pm.mlp_apply
                    else:
                        x, y = image_dataset(0, n + 1000, arch["hw"], arch["ch"], arch["classes"])
                        fn = pm.lenet5_init if kind == "lenet5" else pm.cifarnet_init
                        init = (lambda g, f=fn, a=arch: f(g, a["ch"], a["classes"], a["hw"]))
                        apply_fn = pm.lenet5_apply if kind == "lenet5" else pm.cifarnet_apply
                    t0 = time.perf_counter()
                    params = pm.train_classifier(init, apply_fn, x[:n], y[:n], epochs=t["epochs"],
                                                 lr=t["lr"], seed=0, device=self.dev)
                    torch.cuda.synchronize()
                    row = {"dataset": name, "size": size, "n": n, "epochs": t["epochs"],
                           "train_s": time.perf_counter() - t0}
                    for mode, ncfg in modes.items():
                        _lib.reset_launches()  # this evaluation's run starts here
                        accs = pm.accuracy(apply_fn, params, x[n:], y[n:], ncfg, topk=(1, 5))
                        row[f"{mode}_top1"], row[f"{mode}_top5"] = accs[1], accs[5]
                        row[f"{mode}_launches"] = {k: v for k, v in _lib.launches.items() if v}
                    k1, k3 = (row["plam16_launches"].get(k, 0)
                              for k in ("plam_matmul", "posit_codec"))
                    self.path_launches["plam_matmul"] = (self.path_launches.get("plam_matmul", 0)
                                                         + k1)
                    if not k1 or not k3 or not row["posit16_launches"].get("posit_codec"):
                        failures.append(f"table2 {name}: launches {row}")
                    accs = [row[f"{m}_top{k}"] for m in modes for k in (1, 5)]
                    if not all(np.isfinite(accs)) or not all(0 <= a <= 1 for a in accs):
                        failures.append(f"table2 {name}: accuracies {accs}")
                    delta = row["plam16_top1"] - row["float32_top1"]
                    ref = TABLE2_REFERENCE_QUICK.get(name) if size == "quick" else None
                    ref_s = (f"; the reference --quick: top-1 {ref[:3]}, top-5 {ref[3:]}"
                             if ref else "")
                    log(f"  table2 {name} ({size}: n {n}, {t['epochs']} epochs, trained in "
                        f"{row['train_s']:.1f} s): top-1 f32 {row['float32_top1']:.4f} posit16 "
                        f"{row['posit16_top1']:.4f} plam16 {row['plam16_top1']:.4f}; top-5 "
                        f"{row['float32_top5']:.4f} {row['posit16_top5']:.4f} "
                        f"{row['plam16_top5']:.4f}; plam16 - f32 top-1 {delta:+.4f} (the "
                        f"reference's bar {TABLE2_BAR}, not gated); plam16 launches "
                        f"{row['plam16_launches']}{ref_s}")
                    rows.append(row)
        return {"rows": rows, "k1_checked": self.check_recorded_k1("table2", seen, failures)}

    # -- phase train_families ------------------------------------------------

    def family_cfg(self, arch):
        """``arch`` as its config gives it (its own posit_quant:16:1, its
        dtypes and remat), cut to FAMILY_LAYERS (or --layers, if fewer)
        where the card cannot hold its training whole."""
        from repro_torch.configs import get_config

        cfg = get_config(arch)
        if arch in FAMILY_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=min(FAMILY_LAYERS[arch], self.args.layers))
        return cfg

    def family_batch(self, api, cfg, rows, seq, step):
        """A seeded batch of ``api.train_inputs(rows, seq)`` on the card:
        tokens and labels from lm_batch at ``step``, the stub frontends'
        frames or patch embeddings N(0, 1) from a generator seeded by
        ``step``, in the activation dtype."""
        from repro_torch.data.synthetic import DataConfig, lm_batch

        spec = api.train_inputs(rows, seq)
        b, s = spec["tokens"].shape
        batch = {k: v.to(self.dev) for k, v in
                 lm_batch(DataConfig(seed=0, vocab=cfg.vocab, seq_len=s, global_batch=b),
                          step).items()}
        g = self.gen(1000 + step)
        for name, t in spec.items():
            if name not in batch:
                batch[name] = self.torch.randn(t.shape, generator=g, device=self.dev).to(t.dtype)
        return batch

    @staticmethod
    def family_quantize_count(cfg, positions):
        """K3 quantizes of a training step, by hand: both operands of every
        projection of a forward (``launch_counts``' K1 a plam_sim forward,
        and the encdec's encoder pass), the head's once a 512-position
        chunk of the loss; the backward recomputes each chunk (its
        checkpoint) and, under remat, every layer.  Returns (forward,
        step)."""
        lc = launch_counts(cfg)
        layers = 2 * (lc["k1"] - 1 + lc["enc_k1"])
        head = 2 * -(-positions // 512)
        remat = cfg.remat and cfg.family in ("dense", "moe", "vlm")
        return layers + head, layers + 2 * head + (layers if remat else 0)

    @staticmethod
    def family_flops(cfg, model, rows, positions, src):
        """Model FLOPs of a training step from the parameters that
        multiply, each times the rows it meets: a 2-D projection or the
        router the positions (the encdec's frontend, encoder and
        cross-attention K/V the source frames), an expert stack its
        capacity; 2 N T a forward, twice that the backward, and 2 N T
        again for what the backward recomputes (each loss chunk's head,
        under remat every layer).  The embedding (a gather), the norms,
        the conv and the scan's leaves do not count; the hybrid's shared
        block counts once an invocation.  Returns (FLOPs, the parameters
        counted, their rows-weighted sum N T)."""
        t = rows * positions
        cap = max(1, int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor)) \
            if cfg.n_experts else 0
        # the hybrid's shared block runs once an invocation
        inv = cfg.n_layers // cfg.shared_attn_every if cfg.family == "hybrid" else 1
        head, body, n_mm = 0, 0, 0
        for name, p in model.named_parameters():
            if name == "embed" or p.dim() < 2 or name.endswith("conv_w"):
                continue
            n_mm += p.numel()
            if name == "unembed":
                head += p.numel() * t
            elif p.dim() == 3:
                body += p.numel() * cap
            elif cfg.family == "encdec" and (name.startswith("enc_layers") or
                                             name == "frontend_proj" or
                                             ".xattn.wk" in name or ".xattn.wv" in name):
                body += p.numel() * rows * src
            elif name.startswith("shared."):
                body += p.numel() * t * inv
            else:
                body += p.numel() * t
        remat = cfg.remat and cfg.family in ("dense", "moe", "vlm")
        fwd = 2 * (head + body)
        return 3 * fwd + 2 * head + (2 * body if remat else 0), n_mm, head + body

    @contextlib.contextmanager
    def recording_k3(self, name: str = "posit_quantize"):
        """K3's ``name`` wrapper (posit_quantize or posit_decode) while the
        block runs, by (shape, dtype): its launches and, checked at the
        first launch of each there and then, the lanes of its output that
        differ from the plain version on the same operands (over slices of
        PLAIN_LANES lanes, which bound the compared copy at qwen2-vl-72b's
        unembed; the plain versions' bodies are called from numerics, so
        that no counting_plain sees them)."""
        torch = self.torch
        from repro_torch.kernels import posit_codec
        from repro_torch.kernels.ref import PLAIN_LANES
        from repro_torch.numerics import P16, decode, encode, unpack16

        real = getattr(posit_codec, name)

        def plain(part, spec):  # the plain versions' bodies, out of counting_plain's sight
            if name == "posit_quantize":
                return decode(encode(part, spec), spec)
            return decode(unpack16(part) if part.dtype == torch.int16 else part, spec)

        seen = {}

        def recorded(x, spec=P16, *, use_kernel=None):
            out = real(x, spec, use_kernel=use_kernel)
            if x.is_cuda:
                key = (tuple(x.shape), str(x.dtype)[6:])
                if key not in seen:
                    xf, of = x.reshape(-1), out.reshape(-1)
                    bad = 0
                    for i in range(0, xf.numel(), PLAIN_LANES):
                        want = plain(xf[i:i + PLAIN_LANES], spec)
                        bad += int((of[i:i + PLAIN_LANES].view(torch.int32)
                                    != want.view(torch.int32)).sum())
                    seen[key] = {"shape": list(key[0]), "dtype": key[1], "launches": 0,
                                 "lanes_differ": bad}
                seen[key]["launches"] += 1
            return out

        setattr(posit_codec, name, recorded)
        try:
            yield seen
        finally:
            setattr(posit_codec, name, real)

    @contextlib.contextmanager
    def recording_ssd_exponent(self):
        """The largest exponent that the SSD scan's masked (upper) triangle
        of ``exp(dec)`` reaches while the block runs (``ssm._ssd_chunked``:
        within a chunk, the decay summed from its second position to its
        last), kept on the card; ``take()`` reads it and starts over (None
        where no scan ran).  Above 88.7 its f32 exp is inf, and the
        backward's 0 x inf a NaN."""
        torch = self.torch
        from repro_torch.models import ssm as ssm_mod

        real, box = ssm_mod._ssd_chunked, {"max": None}

        def recorded(xh, bs, cs, dt, a_log, chunk):
            with torch.no_grad():
                s = dt.shape[1]
                q = min(chunk, s)
                la = torch.nn.functional.pad(torch.exp(a_log)[None, None, :] * dt,
                                             (0, 0, 0, (-s) % q))
                top = la.reshape(la.shape[0], -1, q, la.shape[-1])[:, :, 1:].sum(dim=2).amax()
                box["max"] = top if box["max"] is None else torch.maximum(box["max"], top)
            return real(xh, bs, cs, dt, a_log, chunk)

        def take():
            top, box["max"] = box["max"], None
            return None if top is None else float(top)

        ssm_mod._ssd_chunked = recorded
        try:
            yield take
        finally:
            ssm_mod._ssd_chunked = real

    def phase_train_families(self):
        """Training of the MoE, ssm, hybrid, encdec and vlm families on the
        card, each model at full width under its config's own
        posit_quant:16:1 (K3's quantize on both operands of every
        projection): TRAIN_STEPS AdamW steps, then the trained mamba2-780m
        and deepseek-moe-16b served prequantized through K1 (and K2), each
        family at 2 layers on the kernels against the plain versions, and
        yi-6b's blockwise attention against its plain core (phase times
        times K3's quantize at the new shapes)."""
        torch = self.torch
        import gc

        self.yi_model = None  # the earlier phases' model
        gc.collect()
        torch.cuda.empty_cache()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        log(f"train_families: TF32 matmul allowed: {tf32}; float32 matmul precision "
            f"{torch.get_float32_matmul_precision()!r} (the whole step, backward included)")
        failures = [] if not tf32 else ["TF32 is on: f32 matmuls would not be f32"]
        res = {"tf32": tf32, "models": {}}
        for arch in FAMILY_ARCHS:
            model, res["models"][arch] = self.train_family(arch, failures)
            if arch in FAMILY_SERVED:
                res["models"][arch]["served"] = self.serve_trained_family(
                    arch, res["models"][arch]["cfg"], model, failures)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        res["plain"] = {arch: self.family_against_plain(arch, failures) for arch in FAMILY_ARCHS}
        res["blockwise"] = self.blockwise_step(failures)
        for r in res["models"].values():
            r.pop("cfg")
        self.results["train_families"] = res
        if failures:
            raise AssertionError("; ".join(failures[:8]))

    def train_family(self, arch, failures):
        """``arch`` trained at full width (family_steps).  The ssm and
        hybrid first run at TRAIN_LR: where the SSD scan's masked exponent
        passes F32_EXP_MAX, the reference's form gives NaN gradients
        (mirrored, ``tests/test_torch_train_families.py``), so a
        non-finite loss there must follow such a step, and the trained
        model is a second run at FAMILY_SSM_LR, which must stay finite.
        Returns (the trained model, its record)."""
        import gc

        cfg = self.family_cfg(arch)
        profiled = arch in FAMILY_PROFILED
        if cfg.family not in ("ssm", "hybrid"):
            return self.family_steps(arch, cfg, TRAIN_LR, failures, profiled=profiled)
        model, first = self.family_steps(arch, cfg, TRAIN_LR, failures, overflow_ok=True)
        del model
        gc.collect()
        self.torch.cuda.empty_cache()
        model, rec = self.family_steps(arch, cfg, FAMILY_SSM_LR, failures, profiled=profiled)
        rec["at_train_lr"] = first
        return model, rec

    def family_steps(self, arch, cfg, lr, failures, overflow_ok=False, phase="train_families",
                     profiled=False):
        """TRAIN_STEPS AdamW steps (learning rate ``lr``) of ``cfg``'s model
        from its seeded init through make_train_step on seeded
        ``train_inputs`` batches: losses (finite, falling), each step's
        seconds and K3 launches against the hand count (confirmed by a
        no-grad forward, which also reads batch 0's loss after the steps),
        every float leaf's first moment after step 0
        (finite, not all zero), no plain codec or K1 call on the card, K3's
        quantize bit for bit at every (shape, dtype) launched, the SSD
        scan's largest masked exponent, step p50, tokens/s, the f32-peak
        share and peak memory; with ``profiled``, one more step under
        the profiler (profile_train_step).  With
        ``overflow_ok``, non-finite losses pass where an earlier step met
        a masked exponent above F32_EXP_MAX (and are reported).  Returns
        (the trained model, its record)."""
        torch = self.torch
        import numpy as np

        from repro_torch.configs import get_config
        from repro_torch.core.policy import describe
        from repro_torch.kernels import _lib
        from repro_torch.models import build
        from repro_torch.models.registry import vlm_patches
        from repro_torch.models.transformer import set_trainable
        from repro_torch.optim.optimizers import OptConfig, init_state
        from repro_torch.train.loop import TrainConfig, make_train_step

        full = get_config(arch)
        vlm = cfg.family == "vlm"
        rows, seq = (FAMILY_VLM_ROWS, vlm_patches(cfg) + TRAIN_SEQ) if vlm else \
            (TRAIN_BATCH, TRAIN_SEQ)
        api = build(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = set_trainable(api.init(seed=0, device=self.dev))
        n_params = sum(p.numel() for p in model.parameters())
        tcfg = TrainConfig(opt=OptConfig(name="adamw", lr=lr))
        state = init_state(tcfg.opt, model)
        step = make_train_step(api.train_loss, tcfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batch0 = self.family_batch(api, cfg, rows, seq, 0)
        n_tok = batch0["tokens"].numel()
        positions = batch0["tokens"].shape[1] + (vlm_patches(cfg) if vlm else 0)
        src = batch0["frames"].shape[1] if "frames" in batch0 else 0
        flops, n_mm, _ = self.family_flops(cfg, model, rows, positions, src)
        fwd_k3, want_k3 = self.family_quantize_count(cfg, positions)
        depth = (f"{cfg.enc_layers} + {cfg.dec_layers} layers" if cfg.family == "encdec" else
                 f"{cfg.n_layers} of {full.n_layers} layers")
        cut = (f"; cut in depth: {n_params / 1e9:.3f} G parameters x 12 bytes (bf16 weights "
               f"and gradients, f32 AdamW m and v) = {12 * n_params / 1e9:.1f} GB, where all "
               f"{full.n_layers} layers would not fit 80 GB" if cfg.n_layers < full.n_layers
               else "")
        shapes = {k: list(v.shape) for k, v in batch0.items()}
        log(f"{phase}: {arch} ({cfg.family}) d_model {cfg.d_model}, {depth}, vocab "
            f"{cfg.vocab}, param/act {cfg.param_dtype}/{cfg.act_dtype}, remat {cfg.remat}, "
            f"numerics {describe(cfg.numerics)!r}, AdamW lr {lr}; {n_params / 1e9:.3f} G "
            f"parameters ({n_mm / 1e9:.3f} G multiply){cut}; batch {shapes}; init and state "
            f"{init_s:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        losses, secs, k3, exps = [], [], [], []
        with self.recording_k3() as seen, self.counting_plain() as plain_calls, \
                self.recording_ssd_exponent() as take_exp:
            for i in range(TRAIN_STEPS):
                batch = batch0 if i == 0 else self.family_batch(api, cfg, rows, seq, i)
                torch.cuda.synchronize()
                if i == 1:  # step 0 held the plain checks of K3's first launches
                    peak0 = torch.cuda.max_memory_allocated() / 2**30
                    torch.cuda.reset_peak_memory_stats()
                _lib.reset_launches()  # this step's run starts here
                t0 = time.perf_counter()
                _, _, metrics = step(model, state, batch)
                loss = float(metrics["loss"])
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(loss)
                k3.append(_lib.launches["posit_codec"])
                exps.append(take_exp())
                if i == 0:
                    bad = [n for n, m in state["m"].items()
                           if not bool(torch.isfinite(m).all()) or not bool(m.any())]
                    if bad:
                        failures.append(f"{arch}: gradients non-finite or all zero: {bad[:4]}")
                    n_leaves = len(state["m"])
                log(f"  step {i}: loss {loss:.4f}, {secs[-1]:.3f} s, K3 launches {k3[-1]}"
                    + (f", largest masked SSD exponent {exps[-1]:.2f}" if exps[-1] is not None
                       else ""))
            peak = torch.cuda.max_memory_allocated() / 2**30
            with torch.no_grad():
                _lib.reset_launches()
                held = float(api.train_loss(model, batch0))
                fwd_measured = _lib.launches["posit_codec"]
            profile = (self.profile_train_step(step, model, state,
                                               self.family_batch(api, cfg, rows, seq,
                                                                 TRAIN_STEPS))
                       if profiled else None)
        p50 = float(np.quantile(secs, 0.5))
        share = flops / p50 / F32_FLOPS
        differ = [s for s in seen.values() if s["lanes_differ"]]
        self.path_launches["posit_codec"] = self.path_launches.get("posit_codec", 0) + sum(k3)
        log(f"  {arch}: losses {[round(x, 4) for x in losses]}, batch 0's {held:.4f} after "
            f"them; step p50 {p50:.3f} s, "
            f"{n_tok / p50:.1f} tokens/s ({rows * positions / p50:.1f} positions/s); model "
            f"FLOPs a step {flops / 1e12:.2f} T = {share:.3f} of the {F32_FLOPS / 1e12:.0f} "
            f"TFLOP/s f32 peak; peak {peak:.2f} GiB over steps 1-{TRAIN_STEPS - 1} ({peak0:.2f} "
            f"GiB in step 0, with its plain checks); {n_leaves} float leaves")
        log(f"  K3 posit_quantize a step {k3} (hand count {want_k3}: forward {fwd_k3}, measured "
            f"{fwd_measured} in a no-grad forward); plain calls on the card {plain_calls}; "
            f"K3 quantize at {len(seen)} (shape, dtype), each first launch against the plain "
            f"version: {'bit-identical' if not differ else differ}: "
            f"{[(s['shape'], s['dtype'], s['launches']) for s in seen.values()]}")
        finite = [bool(np.isfinite(x)) for x in losses]
        # the step whose update met an overflowing scan (its exponent is
        # read in the forward of the step after it too)
        over = next((i for i, e in enumerate(exps) if e is not None and not e <= F32_EXP_MAX),
                    None)
        mirrored = (overflow_ok and not all(finite) and over is not None
                    and all(finite[:over + 1]) and over < finite.index(False))
        if mirrored:
            log(f"  {arch} at lr {lr}: the masked SSD exponent {exps[over]:.2f} in step {over} "
                f"passes {F32_EXP_MAX} (exp is inf in f32), and the losses are NaN from step "
                f"{finite.index(False)}: the reference's overflow, mirrored (not gated)")
        elif not all(finite) or not losses[-1] < losses[0]:
            failures.append(f"{arch} at lr {lr}: losses {losses}, masked SSD exponents {exps}")
        if any(n != want_k3 for n in k3) or fwd_measured != fwd_k3:
            failures.append(f"{arch}: K3 launches {k3}, forward {fwd_measured}; expected "
                            f"{want_k3} and {fwd_k3}")
        if any(plain_calls.values()):
            failures.append(f"{arch}: plain calls on the card {plain_calls}")
        if differ or not seen:
            failures.append(f"{arch}: K3 quantize differs from its plain version: {differ}")
        del state, step
        return model, {
            "cfg": cfg, "layers": cfg.n_layers, "full_layers": full.n_layers, "lr": lr,
            "params": n_params, "matmul_params": n_mm, "batch": shapes, "losses": losses,
            "batch0_loss_after": held, "overflow_mirrored": mirrored,
            "step_s": secs, "step_p50_s": p50, "tokens_per_s": n_tok / p50,
            "positions_per_s": rows * positions / p50, "model_flops": flops,
            "f32_peak_share": share, "peak_gib": peak, "peak_step0_gib": peak0,
            "k3_per_step": k3, "k3_forward": fwd_measured, "k3_hand_count": want_k3,
            "k3_forward_hand_count": fwd_k3, "plain_calls": dict(plain_calls),
            "k3_shapes": list(seen.values()), "ssd_max_masked_exponent": exps,
            "step_profile": profile}

    def serve_trained_family(self, arch, cfg, model, failures):
        """The trained ``arch`` under default=plam_sim:16:1, encoded to int16
        in place, serving 4 seeded requests of FAMILY_SERVE_NEW new tokens
        on the kernels and on the plain versions: mamba2 on the static
        engine (FAMILY_SERVE_PROMPT tokens), deepseek on the continuous
        engine (the serve phase's prompts).  Greedy tokens equal, or where
        one differs a plain top-2 margin below E2E_LOGIT_TOL (the
        serve-paths rule); for deepseek, the first point where the runs
        part (first_departure) is a token pick under that rule or a
        routing call at a router top-k margin below MOE_ROUTE_TOL (the
        router probabilities' largest difference up to there printed), and
        the kernels with K2 alone plain (plain_k2) do not part from the
        plain run.  The kernels' forwards are held to
        their launch counts, the plain runs to none."""
        from repro_torch.core.prequant import quantize_params
        from repro_torch.kernels import _lib
        from repro_torch.kernels import ref as k1_ref
        from repro_torch.models.transformer import set_trainable
        from repro_torch.serving import Engine, ServeOptions

        set_trainable(model, False)
        scfg = cfg.with_numerics("default=plam_sim:16:1")
        counts = launch_counts(scfg)
        _lib.reset_launches()
        quantize_params(scfg, model)
        encodes = _lib.launches["posit_codec"]
        self.path_launches["posit_codec"] = self.path_launches.get("posit_codec", 0) + encodes
        if encodes != counts["build"]:
            failures.append(f"trained {arch}: {encodes} weight encodes, expected "
                            f"{counts['build']}")
        # the plain K1 walks k once a column slice: wider slices, as in
        # phase archs' 2-layer checks (the card holds the one model)
        plain_lanes, k1_ref.PLAIN_LANES = k1_ref.PLAIN_LANES, 1 << 28
        try:
            if cfg.family == "moe":
                _, prompts = self.moe_prompts(cfg.vocab)
                opts = ServeOptions(max_new_tokens=FAMILY_SERVE_NEW, block_size=16,
                                    max_slots=4, num_blocks=64, max_seq_len=128)
                runs, events = {}, {}
                for uk in (None, False):
                    with self.recording_serve_events() as events[uk]:
                        runs[uk] = self.serve_run(
                            f"trained {arch} prequantized, "
                            f"{'kernels' if uk is None else 'plain'} (routing and picks "
                            f"recorded: not a speed reading)", scfg, model,
                            dataclasses.replace(opts, use_kernel=uk), prompts,
                            new_tokens=FAMILY_SERVE_NEW)
                bad = self.moe_gates(runs[None], scfg, False)
                self.count_moe_path(runs[None]["launches"])
                diffs, perturbation = self.first_departure(events[None], events[False],
                                                           cfg.top_k)
                with self.plain_k2(), self.recording_serve_events() as k2_events:
                    k2_run = self.serve_run(
                        f"trained {arch} prequantized, kernels with K2 alone plain (the "
                        f"cause's witness: not a speed reading)", scfg, model, opts, prompts,
                        new_tokens=FAMILY_SERVE_NEW)
                witness, _ = self.first_departure(k2_events, events[False], cfg.top_k)
                k2_launches = k2_run["launches"].get("paged_decode_attention", 0)
                if witness or k2_launches:
                    bad.append(f"with K2 alone plain ({k2_launches}"
                               f" K2 launches) the runs part from the plain run: {witness}")
                log(f"  trained {arch}: router probabilities' largest |difference| between "
                    f"the kernels' and the plain run up to where they part {perturbation:.3e}; "
                    f"the kernels with K2 alone plain against the plain run: "
                    f"{'no departure' if not witness else witness}")
                extra = {"router_prob_perturbation": perturbation, "k2_plain_departure": witness,
                         "k2_plain_outputs": k2_run["outputs"]}
            else:
                prompts = self.static_prompts(cfg.vocab, 4, FAMILY_SERVE_PROMPT, 29)
                eng = Engine(scfg, params=model, device=self.dev)
                runs = {}
                for uk in (None, False):
                    eng.use_kernel = uk
                    runs[uk] = self.static_run(f"trained {arch} prequantized, "
                                               f"{'kernels' if uk is None else 'plain'}", eng,
                                               prompts, FAMILY_SERVE_NEW)
                bad = self.static_gates(runs[None], counts["k1"], 0)
                self.path_launches["plam_matmul"] = (self.path_launches.get("plam_matmul", 0)
                                                     + runs[None]["launches"]["plam_matmul"])
                diffs = self.static_diffs(runs[None], runs[False])
                extra = {}
                del eng
        finally:
            k1_ref.PLAIN_LANES = plain_lanes
        launched = {k: v for k, v in runs[False]["launches"].items() if v}
        if launched:
            bad.append(f"the plain run launched {launched}")
        failures.extend(f"trained {arch}: {f}" for f in bad)
        if any(d.get("plain_top2_margin", 0.0) >= E2E_LOGIT_TOL or
               d.get("router_topk_margin", 0.0) >= MOE_ROUTE_TOL for d in diffs):
            failures.append(f"trained {arch}: the runs part at a margin above the rule's "
                            f"(top-2 {E2E_LOGIT_TOL}, router top-k {MOE_ROUTE_TOL}): {diffs}")
        log(f"  trained {arch} served: tokens {'equal' if not diffs else diffs} "
            f"({runs[None]['outputs'][0][:8]}...), {encodes} weight encodes")
        return {"encodes": encodes, "diffs": diffs, **extra,
                **{("kernels" if uk is None else "plain"):
                   {k: v for k, v in r.items() if k not in ("calls", "first_decode")}
                   for uk, r in runs.items()}}

    @contextlib.contextmanager
    def recording_serve_events(self):
        """The continuous engine's routing calls (``moe.route``: the chosen
        experts and the router logits) and token picks (``_pick_one``: the
        request, the token's index, the token and the logits' top-2
        margin), in the order they happen, while the block runs."""
        import numpy as np

        from repro_torch.models import moe as moe_mod
        from repro_torch.serving.engine import ContinuousBatchingEngine as cls

        route, pick, events = moe_mod.route, cls._pick_one, []

        def recorded_route(logits, top_k, cap):
            out = route(logits, top_k, cap)
            events.append(("route", out[1].cpu(), logits.detach().float().cpu()))
            return out

        def recorded_pick(eng, logits_row, req, token_idx):
            tok = pick(eng, logits_row, req, token_idx)
            top = np.sort(logits_row)[-2:]
            events.append(("pick", req.rid, token_idx, tok, float(top[1] - top[0])))
            return tok

        moe_mod.route, cls._pick_one = recorded_route, recorded_pick
        try:
            yield events
        finally:
            moe_mod.route, cls._pick_one = route, pick

    @contextlib.contextmanager
    def plain_k2(self):
        """K2 alone on its plain version while the block runs (every other
        kernel as the caller asks)."""
        import importlib

        # the package's decode_attention is K5's wrapper, not this module
        k2 = importlib.import_module("repro_torch.kernels.decode_attention")
        real = k2.paged_decode_attention

        def plain(q, k_pool, v_pool, block_tables, lengths, *, use_kernel=None):
            return k2.paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths)

        k2.paged_decode_attention = plain
        try:
            yield
        finally:
            k2.paged_decode_attention = real

    @staticmethod
    def first_departure(got, want, top_k):
        """Where two recorded serving runs (recording_serve_events) first
        part, if they do: a routing call whose chosen experts differ (each
        differing token with the router's top-k margin in ``want``, the
        k-th probability less the next, and its swap margin, the gap
        between ``want``'s probabilities at the first rank where the two
        choices differ and the next) or a token pick that differs (with
        ``want``'s top-2 logit margin there).  Both runs make the same
        calls in the same order up to there; what follows descends from
        it.  Returns (the departure, [] where they never part; the largest
        |difference| of a router probability over the routing calls up to
        it)."""
        import torch

        perturbation = 0.0
        for g, w in zip(got, want):
            if g[0] != w[0]:
                return [{"event": "structure", "got": g[0], "want": w[0],
                         "router_topk_margin": float("inf")}], perturbation
            if g[0] == "route":
                pw = torch.softmax(w[2], dim=-1)
                perturbation = max(perturbation,
                                   float((torch.softmax(g[2], dim=-1) - pw).abs().max()))
                if not torch.equal(g[1], w[1]):
                    differ = g[1].view(-1, top_k) != w[1].view(-1, top_k)
                    probs = pw.sort(dim=-1, descending=True).values
                    out = []
                    for r in differ.any(dim=1).nonzero()[:, 0].tolist():
                        j = int(differ[r].nonzero()[0, 0])
                        out.append({"event": "route", "token": r,
                                    "router_topk_margin": float(probs[r, top_k - 1]
                                                                - probs[r, top_k]),
                                    "router_swap_margin": float(probs[r, j] - probs[r, j + 1])})
                    return out, perturbation
            if g[0] == "pick" and g[1:4] != w[1:4]:
                return [{"event": "pick", "request": w[1], "position": w[2], "got": g[3],
                         "want": w[3], "plain_top2_margin": w[4]}], perturbation
        return [], perturbation

    def family_against_plain(self, arch, failures):
        """``arch`` at FAMILY_PLAIN_LAYERS layers (zamba2 at its first shared
        block's 6; both encdec stacks), from a seeded init: the loss and
        every float leaf's gradient of one training batch (1 x
        FAMILY_PLAIN_SEQ positions) on the kernels and on the plain
        versions, under deterministic algorithms (the embedding's and the
        MoE gathers' backward otherwise add with atomics).  K3 is
        bit-identical, so loss and gradients must be equal bit for bit."""
        torch = self.torch
        import gc

        from repro_torch.models import build
        from repro_torch.models.registry import vlm_patches
        from repro_torch.models.transformer import set_trainable

        cfg = self.family_cfg(arch)
        cut = cfg.shared_attn_every if cfg.family == "hybrid" else FAMILY_PLAIN_LAYERS
        cfg = dataclasses.replace(cfg, n_layers=cut, enc_layers=min(cfg.enc_layers, cut),
                                  dec_layers=min(cfg.dec_layers, cut))
        api = build(cfg)
        model = set_trainable(api.init(seed=1, device=self.dev))
        named = {n: p for n, p in model.named_parameters() if p.is_floating_point()}
        seq = FAMILY_PLAIN_SEQ // 2 + vlm_patches(cfg) if cfg.family == "vlm" else \
            FAMILY_PLAIN_SEQ
        batch = self.family_batch(api, cfg, 1, seq, 7)
        if cfg.family == "vlm":  # half the positions patches
            batch["embeds_prefix"] = batch["embeds_prefix"][:, :FAMILY_PLAIN_SEQ // 2]
        out = {}
        det = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for uk in (None, False):
                loss = api.train_loss(model, batch, use_kernel=uk)
                grads = torch.autograd.grad(loss, list(named.values()))
                out[uk] = (loss.detach(), grads)
                del loss
        finally:
            torch.use_deterministic_algorithms(det)
        (lk, gk), (lp, gp) = out[None], out[False]
        differ = {}
        for n, a, b in zip(named, gk, gp):
            if not torch.equal(a, b):
                differ[n] = float((a.float() - b.float()).abs().max())
        loss_equal = bool(torch.equal(lk, lp))
        finite = bool(torch.isfinite(lk)) and all(bool(torch.isfinite(g).all()) for g in gk)
        log(f"  {arch} at {cut} layers, one batch of {seq} positions: loss {float(lk):.6f} on "
            f"the kernels, {float(lp):.6f} plain ({'equal' if loss_equal else 'DIFFER'}); "
            f"{len(named) - len(differ)} of {len(named)} gradient leaves bit-identical"
            + (f", the rest's max |difference| {differ}" if differ else ""))
        if not (loss_equal and finite) or differ:
            failures.append(f"{arch} at {cut} layers: kernels against plain: loss "
                            f"{float(lk)} / {float(lp)}, differing leaves {list(differ)[:4]}")
        del model, out, gk, gp
        gc.collect()
        torch.cuda.empty_cache()
        return {"layers": cut, "positions": seq, "loss": float(lk), "loss_equal": loss_equal,
                "leaves": len(named), "leaves_differ": differ}

    def blockwise_step(self, failures):
        """yi-6b at full width cut to BLOCKWISE_LAYERS, f32 parameters,
        activations and numerics (so that the CPU tests' f32 tolerances
        apply), remat as its config: the loss and gradients of one
        BLOCKWISE_BATCH x BLOCKWISE_SEQ batch with flash_block =
        BLOCKWISE_BLOCK and without it, each with its peak memory above
        the model's."""
        torch = self.torch
        import gc

        from repro_torch.configs import get_config
        from repro_torch.data.synthetic import DataConfig, lm_batch
        from repro_torch.models import build
        from repro_torch.models.transformer import set_trainable

        base = dataclasses.replace(get_config("yi-6b"), n_layers=BLOCKWISE_LAYERS,
                                   param_dtype="float32", act_dtype="float32")
        base = base.with_numerics("default=f32")
        model = set_trainable(build(base).init(seed=0, device=self.dev))
        named = dict(model.named_parameters())
        batch = lm_batch(DataConfig(seed=0, vocab=base.vocab, seq_len=BLOCKWISE_SEQ,
                                    global_batch=BLOCKWISE_BATCH), 0)
        out = {}
        for fb in (BLOCKWISE_BLOCK, 0):
            api = build(dataclasses.replace(base, flash_block=fb))
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = api.train_loss(model, batch)
            grads = torch.autograd.grad(loss, list(named.values()))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            out[fb] = (float(loss.detach()), grads, peak, secs)
            del loss
        (lf, gf, pf, sf), (l0, g0, p0, s0) = out[BLOCKWISE_BLOCK], out[0]
        errs = {n: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
                for n, a, b in zip(named, gf, g0)}
        worst = max(errs, key=errs.get)
        loss_err = abs(lf - l0) / abs(l0)
        scores = BLOCKWISE_BATCH * base.n_heads * BLOCKWISE_SEQ ** 2 * 4 / 2**30
        log(f"  blockwise attention, yi-6b at {BLOCKWISE_LAYERS} layers (f32), "
            f"{BLOCKWISE_BATCH} x {BLOCKWISE_SEQ}: loss {lf:.6f} with flash_block="
            f"{BLOCKWISE_BLOCK}, {l0:.6f} without (relative {loss_err:.2e}, tol "
            f"{BLOCKWISE_LOSS_RTOL}); worst gradient leaf {worst} {errs[worst]:.2e} (tol "
            f"{BLOCKWISE_GRAD_TOL}); peak above the model {pf:.2f} GiB against {p0:.2f} GiB "
            f"(one layer's [S, S] f32 scores {scores:.2f} GiB); {sf:.2f} s against {s0:.2f} s")
        if not loss_err <= BLOCKWISE_LOSS_RTOL or errs[worst] > BLOCKWISE_GRAD_TOL:
            failures.append(f"blockwise: loss {lf} / {l0}, {worst} {errs[worst]}")
        del model, named, out, gf, g0
        gc.collect()
        torch.cuda.empty_cache()
        return {"loss_flash": lf, "loss_plain": l0, "loss_rel_err": loss_err,
                "worst_grad_leaf": worst, "worst_grad_rel_l2": errs[worst],
                "peak_above_model_gib_flash": pf, "peak_above_model_gib_plain": p0,
                "seconds_flash": sf, "seconds_plain": s0}

    @contextlib.contextmanager
    def recording_k1(self, clone_b: bool = True):
        """The first K1 launch over float activations
        (``ops.plam_matmul_float``, which ``plam_dense`` calls) at each
        (A shape and dtype, B shape and dtype, spec) while the block runs:
        copies of its operands and its output, and the count of launches
        at that key.  ``clone_b=False`` keeps B itself, for weights that
        stay as they are while the block runs (served, not trained)."""
        from repro_torch.kernels import ops

        real, seen = ops.plam_matmul_float, {}

        def recorded(x, b, spec, **kw):
            out = real(x, b, spec, **kw)
            key = (tuple(x.shape), str(x.dtype)[6:], tuple(b.shape), str(b.dtype)[6:],
                   (spec.n, spec.es))
            if key not in seen and x.is_cuda:
                seen[key] = [x.detach().clone(), b.clone() if clone_b else b, spec,
                             out.detach().clone(), 0]
            if key in seen:
                seen[key][4] += 1
            return out

        ops.plam_matmul_float = recorded
        try:
            yield seen
        finally:
            ops.plam_matmul_float = real

    def check_recorded_k1(self, what, seen, failures) -> dict:
        """Each launch that recording_k1 kept, its output against K1's plain
        version on the same operands, bit for bit (the plain version over
        row slices of at most K1_PLAIN_LANES lanes of A and of the output).
        No kernel is launched here."""
        torch = self.torch
        from repro_torch.kernels.plam_matmul import plam_matmul_float

        n_before, t0, cases = len(failures), time.perf_counter(), []
        for key in sorted(seen, key=lambda k: (k[0][0], k[0][-1], k[2][-1])):
            x, b, spec, got, calls = seen[key]
            (m, k), n = x.shape[-2:], b.shape[-1]
            rows = max(1, K1_PLAIN_LANES // max(k, n))
            # a launch over a stack of experts: its first K1_GROUPED_CHECKED
            # experts and its last, each against the 2-D plain version
            parts = [(x, b, got)]
            if x.dim() == 3:
                experts = {*range(min(K1_GROUPED_CHECKED, x.shape[0])), x.shape[0] - 1}
                parts = [(x[e], b[e], got[e]) for e in sorted(experts)]
            bad = 0
            for xe, be, ge in parts:
                for r0 in range(0, m, rows):
                    want = plam_matmul_float(xe[r0:r0 + rows], be, spec, use_kernel=False)
                    bad += int((ge[r0:r0 + rows].view(torch.int32)
                                != want.view(torch.int32)).sum())
                    del want
            if bad:
                failures.append(f"{what}: K1 M={m} K={k} N={n} A={key[1]} B={key[3]}: "
                                f"{bad} lanes differ from the plain version")
            cases.append({"m": m, "k": k, "n": n, "a": key[1], "b": key[3], "launches": calls,
                          "experts": x.shape[0] if x.dim() == 3 else 0,
                          "lanes_differ": bad})
        seen.clear()  # the kept operands and outputs
        torch.cuda.synchronize()
        ok = len(failures) == n_before
        secs = time.perf_counter() - t0
        log(f"  {what}: K1 at the {len(cases)} (M, K, N, A, B) it was launched with, each "
            f"launch's output against the plain version on its operands: "
            f"{'bit-identical' if ok else failures[n_before:]} in {secs:.1f} s: "
            f"{[(c['m'], c['k'], c['n'], c['a'], c['b'], c['launches']) for c in cases]}")
        return {"ok": ok, "cases": cases, "seconds": secs}

    # -- phase 10 ------------------------------------------------------------

    def phase_e2e(self):
        torch = self.torch
        from repro_torch.core.prequant import quantize_params
        from repro_torch.kernels import _lib
        from repro_torch.models import transformer as tf

        cfg = self.yi_cfg(2)
        model = tf.lm_init(cfg, seed=1, device=self.dev)
        quantize_params(cfg, model)
        g = torch.Generator().manual_seed(11)
        prompt = torch.randint(0, cfg.vocab, (1, 16), generator=g).to(self.dev)
        bs, nb, slots = 16, 8, 4
        table = torch.zeros((slots, 4), dtype=torch.int32, device=self.dev)
        table[0, :2] = torch.tensor([3, 5], dtype=torch.int32)

        def run(use_kernel):
            kp, vp = tf.paged_kv_pool_init(cfg, nb, bs, torch.bfloat16, self.dev)
            logits, _ = tf.paged_prefill(cfg, model, prompt, kp, vp, table[0, :1], 16,
                                         use_kernel=use_kernel)
            tok = int(logits[0, -1].float().argmax())
            toks, last = [tok], None
            lengths = torch.tensor([16, 0, 0, 0], dtype=torch.int32, device=self.dev)
            for _ in range(4):
                token = torch.zeros((slots, 1), dtype=torch.int32, device=self.dev)
                token[0, 0] = tok
                logits, _ = tf.paged_decode_step(cfg, model, token, kp, vp, table, lengths,
                                                 use_kernel=use_kernel)
                last = logits[0, 0].float()
                tok = int(last.argmax())
                toks.append(tok)
                lengths[0] += 1
            return last, toks

        _lib.reset_launches()
        got, got_toks = run(None)
        used = dict(_lib.launches)
        want, want_toks = run(False)
        err = float((got - want).abs().max())
        agree = sum(a == b for a, b in zip(got_toks, want_toks))
        finite = bool(torch.isfinite(got).all())
        log(f"e2e 2-layer full width: last-logit max_abs_err {err:.3e} (tol {E2E_LOGIT_TOL}, "
            f"|logits| max {float(want.abs().max()):.2f}), greedy agreement "
            f"{agree}/{len(got_toks)} ({got_toks} vs {want_toks}), kernel launches {used}")
        self.results["e2e"] = {"max_abs_err": err, "tol": E2E_LOGIT_TOL,
                               "greedy_agree": agree, "tokens": len(got_toks),
                               "launches": used}
        del model
        torch.cuda.empty_cache()
        served = ("plam_matmul", "paged_decode_attention")
        failures = []
        if (not finite or err > E2E_LOGIT_TOL or min(used[k] for k in served) == 0
                or used["posit_codec"] != 0):
            failures.append(f"e2e: err {err} finite {finite} launches {used}")
        failures += self.e2e_moe()
        failures += self.e2e_mitchell()
        if failures:
            raise AssertionError("; ".join(failures))

    def e2e_moe(self):
        """A 2-layer full-width deepseek-moe-16b, prequantized: one prefill
        and 2 decode steps on the kernels and on the plain versions; the last
        logits within E2E_LOGIT_TOL.  Every routing call is recorded, and
        where the two runs route a token differently the router's top-k
        margin there (the k-th probability less the next one) is logged."""
        torch = self.torch
        from repro_torch.core.prequant import quantize_params
        from repro_torch.kernels import _lib
        from repro_torch.models import moe as moe_mod
        from repro_torch.models import transformer as tf

        cfg = dataclasses.replace(self.moe_cfg("deepseek-moe-16b"), n_layers=2)
        model = tf.lm_init(cfg, seed=1, device=self.dev)
        quantize_params(cfg, model)
        g = torch.Generator().manual_seed(11)
        prompt = torch.randint(0, cfg.vocab, (1, 16), generator=g).to(self.dev)
        bs, nb, slots = 16, 8, 4
        table = torch.zeros((slots, 4), dtype=torch.int32, device=self.dev)
        table[0, :2] = torch.tensor([3, 5], dtype=torch.int32)
        route = moe_mod.route
        routes = []

        def recorded(logits, top_k, cap):
            out = route(logits, top_k, cap)
            routes[-1].append((logits.detach().clone(), out[1].clone()))
            return out

        def run(use_kernel):
            routes.append([])
            kp, vp = tf.paged_kv_pool_init(cfg, nb, bs, torch.bfloat16, self.dev)
            logits, _ = tf.paged_prefill(cfg, model, prompt, kp, vp, table[0, :1], 16,
                                         use_kernel=use_kernel)
            tok = int(logits[0, -1].float().argmax())
            toks, last = [tok], None
            lengths = torch.tensor([16, 0, 0, 0], dtype=torch.int32, device=self.dev)
            for _ in range(2):
                token = torch.zeros((slots, 1), dtype=torch.int32, device=self.dev)
                token[0, 0] = tok
                logits, _ = tf.paged_decode_step(cfg, model, token, kp, vp, table, lengths,
                                                 use_kernel=use_kernel)
                last = logits[0, 0].float()
                tok = int(last.argmax())
                toks.append(tok)
                lengths[0] += 1
            return last, toks

        moe_mod.route = recorded
        try:
            _lib.reset_launches()
            got, got_toks = run(None)
            used = dict(_lib.launches)
            want, want_toks = run(False)
        finally:
            moe_mod.route = route
        err = float((got - want).abs().max())
        finite = bool(torch.isfinite(got).all())
        differ = []
        for call, ((lg, eid), (_, eid_plain)) in enumerate(zip(*routes)):
            k = cfg.top_k
            rows = (eid.view(-1, k) != eid_plain.view(-1, k)).any(dim=1).nonzero()[:, 0]
            probs = torch.softmax(lg.float(), dim=-1).sort(dim=-1, descending=True).values
            for r in rows.tolist():
                differ.append({"call": call, "token": r,
                               "topk_margin": float(probs[r, k - 1] - probs[r, k])})
        log(f"e2e 2-layer full-width deepseek-moe-16b: last-logit max_abs_err {err:.3e} (tol "
            f"{E2E_LOGIT_TOL}, |logits| max {float(want.abs().max()):.2f}), greedy "
            f"{got_toks} vs {want_toks}, kernel launches {used}; routing differs at "
            f"{len(differ)} (call, token) of {sum(r[1].numel() // cfg.top_k for r in routes[0])}"
            + (f": {differ[:8]}" if differ else ""))
        self.results["e2e"]["moe"] = {"max_abs_err": err, "tokens": [got_toks, want_toks],
                                      "launches": used, "routing_differs": differ}
        del model
        torch.cuda.empty_cache()
        if (not finite or err > E2E_LOGIT_TOL or used["plam_matmul_grouped"] != 3 * 2 * 3
                or used["posit_codec"] != 0):
            return [f"e2e moe: err {err} finite {finite} launches {used}"]
        return []

    def e2e_mitchell(self):
        """mitchell_f32 (plain torch on both sides): nmatmul at yi-6b's
        projections at M = MITCHELL_M on the card against the same call on
        the CPU, over the first MITCHELL_CPU_N columns, within rtol
        MITCHELL_RTOL and atol MITCHELL_ATOL."""
        torch = self.torch
        from repro_torch.core.modes import NumericsConfig, nmatmul

        ncfg = NumericsConfig(mode="mitchell_f32")
        g = torch.Generator().manual_seed(29)
        worst, worst_abs, failures = 0.0, 0.0, []
        for k, n in K1_SHAPES:
            x = torch.randn((MITCHELL_M, k), generator=g).to(torch.bfloat16)
            w = (torch.randn((k, n), generator=g) * k ** -0.5).to(torch.bfloat16)
            got = nmatmul(x.to(self.dev), w.to(self.dev), ncfg, out_dtype=torch.float32).cpu()
            cols = min(n, MITCHELL_CPU_N)
            want = nmatmul(x, w[:, :cols].contiguous(), ncfg, out_dtype=torch.float32)
            diff = (got[:, :cols] - want).abs()
            # torch.allclose's criterion: |got - want| <= atol + rtol |want|
            ratio = float((diff / (MITCHELL_ATOL + MITCHELL_RTOL * want.abs())).max())
            worst, worst_abs = max(worst, ratio), max(worst_abs, float(diff.max()))
            if ratio > 1.0 or not bool(torch.isfinite(got).all()):
                failures.append(f"mitchell_f32 K={k} N={n}: |diff| over the allowed {ratio}")
        log(f"e2e mitchell_f32 nmatmul on the card vs the CPU at yi-6b's projections, M = "
            f"{MITCHELL_M} (the first {MITCHELL_CPU_N} columns): largest |diff| "
            f"{worst_abs:.3e}, largest |diff| / (atol + rtol |want|) {worst:.3f} (rtol "
            f"{MITCHELL_RTOL}, atol {MITCHELL_ATOL}; at most 1)")
        self.results["e2e"]["mitchell"] = {"max_abs_diff": worst_abs, "allclose_ratio": worst}
        return failures

    # -- phase 11 ------------------------------------------------------------

    def phase_times(self):
        torch = self.torch

        from repro_torch.kernels.decode_attention import (
            gather_pages,
            paged_decode_attention_kernel,
            paged_decode_attention_ref,
        )
        from repro_torch.kernels.ops import plam_dense
        from repro_torch.kernels.plam_matmul import plam_matmul
        from repro_torch.kernels.posit_codec import posit_encode
        from repro_torch.numerics import P16

        g = self.gen(5)
        rows = []

        def add(name, shape, ms, plain_ms, bytes_, ops, op_rate, library_ms=None, floor_ms=None):
            """ms and library_ms are (window, device) pairs from timed();
            the row's ms and library_ms are the windows, as earlier runs
            read them, and device_ms and library_device_ms the spun ones."""
            t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
            t_ops = ops / op_rate * 1e3
            (ms, dev_ms), (lib_ms, lib_dev_ms) = ms, library_ms or (None, None)
            row = {"name": name, "shape": shape, "ms": ms, "device_ms": dev_ms,
                   "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": lib_ms, "library_device_ms": lib_dev_ms}
            if floor_ms is not None:
                row["design_floor_ms"] = floor_ms
            rows.append(row)
            plain = "not measured" if plain_ms is None else f"{plain_ms:.3f} ms"
            log(f"time {name} {shape}: {ms:.4f} ms, device {dev_ms:.4f} ms (plain "
                f"{plain}, bound {row['bound_ms']:.4f} ms by {row['bound_by']}"
                + (f", library {lib_ms:.4f} ms, device {lib_dev_ms:.4f} ms"
                   if lib_ms is not None else "")
                + (f", design floor {floor_ms:.4f} ms" if floor_ms is not None else "") + ")")
            return row

        def mean(v):
            return sum(v) / len(v)

        def in_turns(pair, fused, digits):
            return [round(v, digits) for v in (pair[0], fused[0], fused[1], pair[1])]

        timed = self.timed
        int_rate = self.int32_ops_per_s()
        # K1 at the decode shapes (M = 4) and one prefill shape (M = 64).
        # Beside the bound, the decode path's floor: every B pattern decoded
        # once and every product's ALU-pipe operations, from the hand count
        with open(K1_SOURCE) as f:
            src = f.read()
        word_ops, row_ops = (int(re.search(rf"constexpr int {c} = (\d+);", src).group(1))
                             for c in ("kLogWordAluOps", "kProductAluOpsPerRow"))
        log(f"K1 ALU-pipe operations (counted in plam_matmul.cuh): log_word {word_ops}, "
            f"product {row_ops} a row")
        # ... and the prefill path's floor: the instructions of its blocks
        # (fast-loop products, k steps, decoded elements, from the hand count
        # in the same header), at INSTR_LANES_PER_SM a clock, over the waves of blocks
        # that the busiest SM runs, at the strip width the library chooses
        p_prod, p_step, p_pat, p_bf16 = (
            int(re.search(rf"constexpr int {c} = (\d+);", src).group(1))
            for c in ("kPrefillProductInstr", "kPrefillStepInstr", "kPrefillPatternInstr",
                      "kPrefillExactBf16Instr"))
        log(f"K1 prefill instructions (counted in plam_matmul.cuh): product {p_prod}, "
            f"k step {p_step}, pattern decode {p_pat}, bf16 decode {p_bf16}")
        from repro_torch.kernels import _lib

        def k1_floor(m, k, n, a_instr):
            """(strip width or None, floor ms) of a K1 call; A decodes at a_instr"""
            if m <= 16:
                return None, (k * n * word_ops + m * k * n * row_ops) / int_rate * 1e3
            bn = _lib.library().plam_matmul_prefill_width(m, n, 1, 16, 1)
            waves = -(-(-(-n // bn) * -(-m // 64)) // SMS)
            per_block = k * (64 * bn * p_prod + 256 * p_step + bn * p_pat + 64 * a_instr)
            return bn, waves * per_block / (INSTR_LANES_PER_SM * self.clock_mhz * 1e6) * 1e3
        k1_main = None
        # wq/wo is timed first and once more last: the first reading of a
        # phase has read high (a start-up effect, or the shape's own time)
        k1_runs = [(4, s) for s in K1_SHAPES] + [(64, (4096, 11008)), (4, K1_SHAPES[0])]
        for i, (m, (k, n)) in enumerate(k1_runs):
            a = posit_encode(torch.randn((m, k), generator=g, device=self.dev), P16)
            b = posit_encode(torch.randn((k, n), generator=g, device=self.dev) * k ** -0.5,
                             P16, out_dtype=torch.int16)
            ms = timed(lambda: plam_matmul(a, b, P16), reps=10)
            plain = self.events_ms(lambda: plam_matmul(a, b, P16, use_kernel=False),
                                   reps=1, warmup=0)
            bn, floor = k1_floor(m, k, n, p_pat)
            again = " (again, last)" if i == len(k1_runs) - 1 else ""
            strip = f" BN={bn}" if bn else ""
            add("plam_matmul", f"M={m} K={k} N={n} B=int16{strip}{again}", ms, plain,
                m * k * 4 + k * n * 2 + m * n * 4, m * k * n, int_rate, floor_ms=floor)
            del a, b
        # K1 over bf16 activations (plam_dense: one launch, the serving
        # path's call) beside the codec-then-matmul pair it replaced, in
        # turns (pair, fused, fused, pair), window and spun, and the host
        # time per call of each
        for m, (k, n) in K1_PAIR_RUNS:
            x = torch.randn((m, k), generator=g, device=self.dev).to(torch.bfloat16)
            b = posit_encode(torch.randn((k, n), generator=g, device=self.dev) * k ** -0.5,
                             P16, out_dtype=torch.int16)
            fused = lambda: plam_dense(x, b, P16)  # noqa: E731
            pair = lambda: plam_matmul(posit_encode(x, P16), b, P16)  # noqa: E731
            turns = {"pair": [], "fused": []}
            for spin in (False, True):
                for name in ("pair", "fused", "fused", "pair"):
                    fn = fused if name == "fused" else pair
                    turns[name].append(self.events_ms(fn, reps=10, spin=spin))
            host = {"pair": [], "fused": []}
            for name in ("pair", "fused", "fused", "pair"):
                host[name].append(self.host_us(fused if name == "fused" else pair))
            plain = self.events_ms(lambda: plam_dense(x, b, P16, use_kernel=False), reps=1,
                                   warmup=0)
            bn, floor = k1_floor(m, k, n, p_bf16)
            strip = f" BN={bn}" if bn else ""
            row = add("plam_matmul", f"fused M={m} K={k} N={n} A=bf16 B=int16{strip}",
                      (mean(turns["fused"][:2]), mean(turns["fused"][2:])), plain,
                      m * k * 2 + k * n * 2 + m * n * 4, m * k * n, int_rate, floor_ms=floor)
            row.update({"turns_ms": turns, "pair_ms": mean(turns["pair"][:2]),
                        "pair_device_ms": mean(turns["pair"][2:]), "host_us": host,
                        "fused_host_us": mean(host["fused"]),
                        "pair_host_us": mean(host["pair"])})
            tp, tf, hp, hf = turns["pair"], turns["fused"], host["pair"], host["fused"]
            log(f"  fused vs pair, in turns (pair, fused, fused, pair): window "
                f"{in_turns(tp[:2], tf[:2], 4)} ms, spun {in_turns(tp[2:], tf[2:], 4)} ms; "
                f"host per call {in_turns(hp, hf, 2)} us")
            if (m, k, n) == (4, 4096, 11008):
                k1_main = row
            del x, b
        # K1 at the multi-token paged path's M (the verify rows and the chunk
        # width), fused over bf16 activations as the path calls it
        for m in K1_CHUNK_MS:
            for k, n in K1_SHAPES:
                x = torch.randn((m, k), generator=g, device=self.dev).to(torch.bfloat16)
                b = posit_encode(torch.randn((k, n), generator=g, device=self.dev) * k ** -0.5,
                                 P16, out_dtype=torch.int16)
                ms = timed(lambda: plam_dense(x, b, P16), reps=10)
                plain = self.events_ms(lambda: plam_dense(x, b, P16, use_kernel=False),
                                       reps=1, warmup=0)
                bn, floor = k1_floor(m, k, n, p_bf16)
                add("plam_matmul", f"fused M={m} K={k} N={n} A=bf16 B=int16 BN={bn} "
                    f"({'verify' if m < SERVE_CHUNK else 'chunk'})", ms, plain,
                    m * k * 2 + k * n * 2 + m * n * 4, m * k * n, int_rate, floor_ms=floor)
                del x, b
        k1_grouped_main = self.time_grouped(add, int_rate, word_ops, row_ops, mean)
        self.time_fused_on_serve_activations()
        k3_main = self.time_encode(add, int_rate)
        ops = self.k3_codec_ops()
        self.k3_criteria(self.time_decode_quantize(add, int_rate, ops)
                         + self.time_train_quantize(add, int_rate, ops))
        self.time_by_lane()
        self.time_table_edge()
        self.time_k3_step()
        self.time_table_fill()
        # K2 at the serving shape (4 sequences of yi-6b heads, bf16 pool) and
        # at a long paged context; the library yardstick is SDPA over the
        # cache gathered beforehand (it leaves out K2's block-table walk)
        k2_main = None
        for lengths, max_blk in [([48, 60, 70, 79], None), (K2_LONG_LENGTHS, K2_LONG_MAX_BLK)]:
            q, kp, vp, tables, lens = self.paged_case(g, lengths, max_blk=max_blk)
            b_, h, hd = q.shape
            kv = kp.shape[2]
            ms = timed(lambda: paged_decode_attention_kernel(q, kp, vp, tables, lens), reps=50)
            plain = self.events_ms(
                lambda: paged_decode_attention_ref(q, kp, vp, tables, lens), reps=20)
            kc = gather_pages(kp, tables).transpose(1, 2).contiguous()  # [B, kv, S, hd]
            vc = gather_pages(vp, tables).transpose(1, 2).contiguous()
            lib_ms = self.timed(self.sdpa(q, kc, vc, lens), reps=50)
            ctx = sum(lengths)
            row = add("paged_decode_attention",
                      f"B={b_} H={h} kv={kv} hd={hd} bs=16 lens={lengths}", ms, plain,
                      q.numel() * 2 * 2 + 2 * ctx * kv * hd * 2 + tables.numel() * 4 + b_ * 4,
                      4 * ctx * h * hd, F32_FLOPS, library_ms=lib_ms)
            k2_main = k2_main or row
            del q, kp, vp, kc, vc
        k4_main = self.time_posit_mul(add, int_rate)
        k5_main = self.time_decode_attention(add)
        self.results["times"] = rows
        self.kernels = {
            "plam_matmul": (k1_main, "src/repro_torch/kernels/csrc/plam_matmul.cuh",
                            "src/repro/kernels/plam_matmul.py:123"),
            "plam_matmul_grouped": (k1_grouped_main,
                                    "src/repro_torch/kernels/csrc/plam_matmul.cuh",
                                    "src/repro/kernels/plam_matmul.py:123"),
            "paged_decode_attention": (
                k2_main, "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
                "src/repro/kernels/decode_attention.py:184"),
            "posit_codec": (k3_main, "src/repro_torch/kernels/csrc/posit_codec.cu",
                            "src/repro/kernels/posit_codec.py:57"),
            "posit_mul": (k4_main, "src/repro_torch/kernels/csrc/posit_mul.cu",
                          "src/repro/kernels/posit_codec.py:85"),
            "decode_attention": (k5_main, "src/repro_torch/kernels/csrc/decode_attention.cu",
                                 "src/repro/kernels/decode_attention.py:83"),
        }

    def time_grouped(self, add, int_rate, word_ops, row_ops, mean):
        """K1 over a stack of experts at deepseek-moe-16b's expert
        projections (64 experts) at K1_GROUPED_TIME_MS, window and spun,
        beside its bytes bound (every int16 pattern read once) and its
        decode path's floor (as the 2-D kernel's, over E experts); then, in
        turns (loop, grouped, grouped, loop), the 64 launches of the 2-D
        kernel that it replaces, with each one's host time per call.
        ``word_ops`` and ``row_ops`` are the 2-D kernel's ALU-pipe counts
        that phase_times read from K1_SOURCE.  Returns the row of the decode
        step's wg/wu projection (M = 1)."""
        torch = self.torch
        from repro_torch.kernels.ops import plam_dense
        from repro_torch.kernels.posit_codec import posit_encode
        from repro_torch.numerics import P16

        g = self.gen(19)
        e = MOE_EXPERTS["deepseek-moe-16b"]
        main = None
        for k, n in MOE_SHAPES["deepseek-moe-16b"]:
            b = posit_encode(torch.randn((e, k, n), generator=g, device=self.dev) * k ** -0.5,
                             P16, out_dtype=torch.int16)
            for m in K1_GROUPED_TIME_MS:
                x = torch.randn((e, m, k), generator=g, device=self.dev).to(torch.bfloat16)
                grouped = lambda: plam_dense(x, b, P16)  # noqa: E731
                xs, bs = list(x.unbind(0)), list(b.unbind(0))
                loop = lambda: [plam_dense(xi, bi, P16) for xi, bi in zip(xs, bs)]  # noqa: E731
                turns = {"loop": [], "grouped": []}
                for spin in (False, True):
                    for name in ("loop", "grouped", "grouped", "loop"):
                        fn = grouped if name == "grouped" else loop
                        turns[name].append(self.events_ms(fn, reps=10, spin=spin))
                host = {"loop": [], "grouped": []}
                for name in ("loop", "grouped", "grouped", "loop"):
                    host[name].append(self.host_us(grouped if name == "grouped" else loop,
                                                   calls=50))
                plain = self.events_ms(lambda: plam_dense(x, b, P16, use_kernel=False),
                                       reps=1, warmup=0)
                # the decode path's floor, as for the 2-D kernel: every B
                # pattern decoded once and every product's ALU-pipe operations
                floor = e * (k * n * word_ops + m * k * n * row_ops) / int_rate * 1e3
                row = add("plam_matmul_grouped", f"E={e} M={m} K={k} N={n} A=bf16 B=int16",
                          (mean(turns["grouped"][:2]), mean(turns["grouped"][2:])), plain,
                          e * (m * k * 2 + k * n * 2 + m * n * 4), e * m * k * n, int_rate,
                          floor_ms=floor)
                row.update({"turns_ms": turns, "loop_ms": mean(turns["loop"][:2]),
                            "loop_device_ms": mean(turns["loop"][2:]), "host_us": host,
                            "grouped_host_us": mean(host["grouped"]),
                            "loop_host_us": mean(host["loop"])})
                tl, tg, hl, hg = turns["loop"], turns["grouped"], host["loop"], host["grouped"]
                log(f"  grouped vs {e} 2-D launches, in turns (loop, grouped, grouped, loop): "
                    f"window {[round(v, 4) for v in (tl[0], tg[0], tg[1], tl[1])]} ms, spun "
                    f"{[round(v, 4) for v in (tl[2], tg[2], tg[3], tl[3])]} ms; host per call "
                    f"{[round(v, 1) for v in (hl[0], hg[0], hg[1], hl[1])]} us")
                if main is None:
                    main = row
                del x
            del b
        return main

    def serve_activations(self):
        """What K1 is given on the serve path: a seeded full-width engine
        (the serve phase's configuration and depth) admits four prompts of
        40, 64, 20 and 10 tokens in one step, so it prefills at M = 48 and
        64 (and 32, 16) and then decodes the four slots at M = 4.  Returns
        {(M, K, N): [(x, weight), ...]} over every plam_dense call of that
        step, in call order (a copy of each x; the weights are the
        engine's)."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.serving import ServeOptions, build_engine

        opts = ServeOptions(max_new_tokens=4, block_size=16, max_slots=4, num_blocks=64,
                            max_seq_len=128, prequantize=True)
        cfg = self.yi_cfg(self.args.layers)
        eng = build_engine(cfg, opts, init_seed=0)
        g = torch.Generator().manual_seed(17)
        for n in (40, 64, 20, 10):
            eng.submit(torch.randint(0, cfg.vocab, (n,), generator=g).tolist(),
                       max_new_tokens=4, arrival_step=0)
        seen, plam_dense = {}, ops.plam_dense

        def spy(x, w, *args, **kw):
            x2 = x.reshape(-1, x.shape[-1])
            seen.setdefault((x2.shape[0], *w.shape), []).append((x2.clone(), w))
            return plam_dense(x, w, *args, **kw)

        ops.plam_dense = spy
        try:
            eng.step()
        finally:
            ops.plam_dense = plam_dense
        torch.cuda.synchronize()
        del eng
        return seen

    def time_fused_on_serve_activations(self):
        """The fused call beside the codec-then-matmul pair on the serve
        path's own activations (serve_activations) at K1_PAIR_RUNS' shapes:
        each timed call runs every captured call of its shape back to back
        (each layer's input with that layer's weight) and is divided by
        their number; spun, behind a spin long enough to queue them all, in
        turns (pair, fused, fused, pair).  Logs the share of the inputs, and
        of their 32-element runs, outside the exact bf16 range (where
        a_word takes the full encode)."""
        torch = self.torch
        from repro_torch.kernels.ops import plam_dense
        from repro_torch.kernels.plam_matmul import plam_matmul
        from repro_torch.kernels.posit_codec import posit_encode
        from repro_torch.numerics import P16

        seen, rows = self.serve_activations(), []
        lo, hi = EXACT_BF16_SCALES
        for m, (k, n) in K1_PAIR_RUNS:
            calls = seen[(m, k, n)]
            xs = torch.cat([x for x, _ in calls])
            bits = xs.view(torch.int16).to(torch.int32) & 0xFFFF
            scale = ((bits >> 7) & 0xFF) - 127
            out = ((bits & 0x7FFF) != 0) & ((scale < lo) | (scale > hi))
            runs = out.view(-1, 32).any(1).float().mean().item()

            def fused():
                for x, w in calls:
                    plam_dense(x, w, P16)

            def pair():
                for x, w in calls:
                    plam_matmul(posit_encode(x, P16), w, P16)

            turns = {"pair": [], "fused": []}
            for name in ("pair", "fused", "fused", "pair"):
                turns[name].append(self.events_ms(fused if name == "fused" else pair, reps=3,
                                                  spin=True, spin_cycles=HOST_SPIN_CYCLES)
                                   / len(calls))
            share = out.float().mean().item()
            rows.append({"shape": f"M={m} K={k} N={n}", "calls": len(calls),
                         "out_of_range": share, "runs_out_of_range": runs,
                         "turns_device_ms": turns})
            log(f"time fused vs pair on serve activations M={m} K={k} N={n} ({len(calls)} calls): "
                f"{share:.4f} of values and {runs:.4f} of 32-value runs outside scales "
                f"[{lo}, {hi}]; spun ms a call, in turns (pair, fused, fused, pair): "
                f"{[round(v, 4) for v in (turns['pair'][0], *turns['fused'], turns['pair'][1])]}")
        self.results["fused_on_serve_activations"] = rows
        del seen
        torch.cuda.empty_cache()

    def k3_input(self, g, shape, kind):
        """A seeded K3 input: "f32" and "bf16" weights N(0, 1/K) (the
        activation shapes N(0, 1)), "bf16 bits" uniform over the 65,024
        finite bf16 patterns."""
        torch = self.torch
        if kind == "bf16 bits":
            pats = torch.arange(1 << 16, dtype=torch.int32, device=self.dev)
            finite = pats[(pats & 0x7F80) != 0x7F80]
            pick = torch.randint(0, finite.numel(), shape, generator=g, device=self.dev)
            return finite[pick].to(torch.int16).view(torch.bfloat16)
        scale = shape[0] ** -0.5 if shape[0] >= 4096 else 1.0
        x = torch.randn(shape, generator=g, device=self.dev) * scale
        return x if kind == "f32" else x.to(torch.bfloat16)

    def time_encode(self, add, int_rate):
        """K3's encode at K3_TIMES, Posit<16,1>: window and spun, beside
        its bound (the bytes; the ALU-pipe operations a table encode
        needs), the floor of the path it takes (the larger of the bytes
        and the path's operations, hand counts in its source), the plain
        version (not at the unembed: its int64 temporaries would take
        tens of GB), and a copy of the same bytes (a torch conversion from
        the input's bits to the output type: what the card's elementwise
        kernels reach here); at K3_HOST_SHAPES also the host time per
        call.  Returns the row of the weight encode [4096, 11008] bf16 ->
        int16."""
        torch = self.torch
        from repro_torch.kernels.posit_codec import encode_path, posit_encode
        from repro_torch.numerics import P16

        with open(K3_SOURCE) as f:
            src = f.read()
        ops = {c: int(re.search(rf"constexpr int {c} = (\d+);", src).group(1))
               for c in ("kEncodeBoundAluOpsPerLane", "kEncodeFixedAluOpsPerLane",
                         "kEncodeTableAluOpsPerLane")}
        log(f"K3 ALU-pipe operations a lane (counted in posit_codec.cu): {ops}")
        path_ops = {"table": ops["kEncodeTableAluOpsPerLane"],
                    "computed": ops["kEncodeFixedAluOpsPerLane"]}
        g = self.gen(15)
        main = None
        for shape, kind, od_name in K3_TIMES:
            od = getattr(torch, od_name)
            x = self.k3_input(g, shape, kind)
            n = x.numel()
            path = encode_path(x.dtype, n, P16)
            ms = self.timed(lambda: posit_encode(x, P16, out_dtype=od), reps=20)
            plain = None
            if n <= 1 << 26:
                plain = self.events_ms(
                    lambda: posit_encode(x, P16, out_dtype=od, use_kernel=False), reps=2)
            word = x.view(torch.int16 if x.element_size() == 2 else torch.int32)
            dst = torch.empty(shape, dtype=od, device=self.dev)
            copy_ms = self.timed(lambda: dst.copy_(word), reps=20)
            bytes_ = n * (x.element_size() + dst.element_size())
            floor = max(bytes_ / HBM_BYTES_PER_S, n * path_ops[path] / int_rate) * 1e3
            row = add("posit_codec", f"encode {list(shape)} {kind}->{od_name} ({path} path)",
                      ms, plain, bytes_, n * ops["kEncodeBoundAluOpsPerLane"], int_rate,
                      floor_ms=floor)
            row.update({"path": path, "copy_ms": copy_ms[0], "copy_device_ms": copy_ms[1]})
            log(f"  copy of the same bytes: {copy_ms[0]:.4f} ms, device {copy_ms[1]:.4f} ms; "
                f"the encode's device time over it {row['device_ms'] / copy_ms[1]:.3f}")
            if shape in K3_HOST_SHAPES:
                row["host_us"] = self.host_us(lambda: posit_encode(x, P16, out_dtype=od))
                log(f"  host per call: {row['host_us']:.2f} us")
            if (shape, kind, od_name) == ((4096, 11008), "bf16", "int16"):
                main = row
            del x, word, dst
        torch.cuda.empty_cache()
        return main

    def k3_by_lane_max(self) -> dict:
        """The lane counts below which K3's computed paths take one lane a
        thread, read from posit_codec.cu: {"decode": kDecodeByLaneMaxLanes,
        "encode": and "quantize": kByLaneMaxLanes}."""
        with open(K3_SOURCE) as f:
            src = f.read()
        decode, other = (int(re.search(rf"constexpr int64_t {c} = (\d+);", src).group(1))
                         for c in ("kDecodeByLaneMaxLanes", "kByLaneMaxLanes"))
        return {"decode": decode, "encode": other, "quantize": other}

    def k3_variants(self) -> dict:
        """K3_VARIANTS, each made from this tree's posit_codec.cu by its
        replacements and built into a library of its own under
        build/k3_variants (every nvcc at once, once a run), with its three
        launches bound; "design" is the port's own library.  Their
        launches pass no wrapper: no count moves."""
        libs = getattr(self, "_k3_libs", None)
        if libs is not None:
            return libs
        import ctypes

        from repro_torch.kernels import _lib

        with open(K3_SOURCE) as f:
            src = f.read()
        out_dir = os.path.join(ROOT, "build", "k3_variants")
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        try:
            for i, (name, edits) in enumerate(K3_VARIANTS.items()):
                text = src
                for old, new in edits:
                    if old not in text:
                        raise AssertionError(f"K3 variant {name!r}: posit_codec.cu no longer "
                                             f"holds {old!r}")
                    text = text.replace(old, new)
                cu, so = (os.path.join(out_dir, f"variant{i}{ext}") for ext in (".cu", ".so"))
                with open(cu, "w") as f:
                    f.write(text)
                cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, f"-I{os.path.dirname(K3_SOURCE)}",
                       "-shared", cu, "-o", so]
                procs.append((name, so, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            libs = {"design": _lib.library()}
            for name, so, proc in procs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"K3 variant {name!r}: nvcc failed:\n{out}")
                lib = ctypes.CDLL(so)
                for fn in ("posit_encode_launch", "posit_decode_launch", "posit_quantize_launch"):
                    getattr(lib, fn).argtypes = _lib._SIGNATURES[fn]
                    getattr(lib, fn).restype = ctypes.c_int
                libs[name] = lib
        finally:
            for _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        log(f"K3 variants {list(K3_VARIANTS)} built in {time.perf_counter() - t0:.1f} s")
        self._k3_libs = libs
        return libs

    def k3_raw(self, lib, op, x, out, table=None):
        """A call of ``lib``'s raw K3 launch ``op`` ("encode", "decode" or
        "quantize") of x into the preallocated out at Posit<16,1>; table:
        the table path's table, or None for the computed path."""
        from repro_torch.kernels import _lib

        stream = self.torch.cuda.current_stream().cuda_stream
        code, n = _lib.DTYPE_CODES[x.dtype], x.numel()
        tp = None if table is None else table.data_ptr()

        def fn():
            if op == "decode":
                err = lib.posit_decode_launch(x.data_ptr(), code, out.data_ptr(), n, 16, 1, stream)
            elif op == "quantize":
                err = lib.posit_quantize_launch(x.data_ptr(), code, out.data_ptr(), n, 16, 1, tp,
                                                stream)
            else:
                err = lib.posit_encode_launch(x.data_ptr(), code, out.data_ptr(),
                                              _lib.DTYPE_CODES[out.dtype], n, 16, 1, tp, stream)
            if err:
                raise RuntimeError(f"K3 raw {op} of {tuple(x.shape)}: launch failed ({err})")
        return fn

    def k3_turns(self, calls: dict, reps: int = 20) -> dict:
        """Spun device ms of each named call after an L2 flush, in turns:
        the names in order, then backwards (first, ..., last, last, ...,
        first)."""
        turns = {name: [] for name in calls}
        for name in list(calls) + list(calls)[::-1]:
            turns[name].append(self.events_ms(calls[name], reps=reps, spin=True))
        return turns

    def k3_same(self, what, got, want):
        """Raises unless got and want hold the same bits."""
        torch = self.torch
        g, w = (t.view(torch.int32) if t.dtype == torch.float32 else t for t in (got, want))
        if got.shape != want.shape or not torch.equal(g, w):
            bad = int((g != w).sum()) if got.shape == want.shape else -1
            raise AssertionError(f"K3 {what}: {bad} lanes differ from the plain version")

    def time_k3_row(self, add, op, x, kind, floor_ops, int_rate, training=False):
        """One K3 decode or quantize row at Posit<16,1>: the wrapper's time,
        window and spun, beside the bytes bound (each input read once, each
        f32 output written once), the design floor (the larger of the
        bytes and floor_ops a lane at the int32 rate), the plain version
        (at most PLAIN_LANES lanes at a time), whose output the wrapper's
        must equal bit for bit, and a copy of the same bytes (a torch
        conversion of x into the f32 output); then the raw launch beside
        the first form's (K3_VARIANTS), in turns."""
        torch = self.torch
        from repro_torch.kernels.posit_codec import (
            encode_path,
            posit_decode,
            posit_quantize,
            quantize_table,
        )
        from repro_torch.numerics import P16

        fn = posit_decode if op == "decode" else posit_quantize
        n = x.numel()
        path = "computed" if op == "decode" else encode_path(x.dtype, n, P16)
        ms = self.timed(lambda: fn(x, P16), reps=20)
        plain = self.events_ms(lambda: fn(x, P16, use_kernel=False), reps=1, warmup=1)
        name = (f"{op} {list(x.shape)} {kind}->float32 ({path} path"
                + (", training)" if training else ")"))
        self.k3_same(name, fn(x, P16), fn(x, P16, use_kernel=False))
        dst = torch.empty(x.shape, dtype=torch.float32, device=self.dev)
        copy_ms = self.timed(lambda: dst.copy_(x), reps=20)
        bytes_ = n * (x.element_size() + 4)
        floor = max(bytes_ / HBM_BYTES_PER_S, n * floor_ops / int_rate) * 1e3
        row = add("posit_codec", name, ms, plain, bytes_, 0, 1.0, floor_ms=floor)
        row.update({"path": path, "copy_ms": copy_ms[0], "copy_device_ms": copy_ms[1],
                    "bound_share": row["bound_ms"] / row["device_ms"]})
        log(f"  copy of the same bytes: {copy_ms[0]:.4f} ms, device {copy_ms[1]:.4f} ms; "
            f"{row['bound_share']:.1%} of the bytes bound")
        libs = self.k3_variants()
        table = quantize_table(P16, self.dev) if path == "table" else None
        turns = self.k3_turns({"first form": self.k3_raw(libs["first form"], op, x, dst),
                               "design": self.k3_raw(libs["design"], op, x, dst, table)})
        old, new = (sum(turns[k]) / 2 for k in ("first form", "design"))
        row.update({"turns_device_ms": turns, "first_form_device_ms": old,
                    "design_device_ms": new, "speedup": old / new})
        order = (turns["first form"][0], *turns["design"], turns["first form"][1])
        log(f"  in turns (first form, design, design, first form), spun: "
            f"{[round(v, 4) for v in order]} ms: {old / new:.2f}x the first form's speed")
        del dst
        return row

    def k3_codec_ops(self):
        """The hand counts of K3's decode and quantize floors, read from the
        header of its source."""
        with open(K3_SOURCE) as f:
            src = f.read()
        ops = {c: int(re.search(rf"constexpr int {c} = (\d+);", src).group(1))
               for c in ("kDecodeFixedAluOpsPerLane", "kQuantizeFixedAluOpsPerLane",
                         "kQuantizeTableAluOpsPerLane")}
        log(f"K3 decode and quantize ALU-pipe operations a lane (counted in posit_codec.cu): "
            f"{ops}")
        return {"decode": ops["kDecodeFixedAluOpsPerLane"],
                "computed": ops["kQuantizeFixedAluOpsPerLane"],
                "table": ops["kQuantizeTableAluOpsPerLane"]}

    def k3_codec_input(self, g, op, shape, kind):
        """A seeded input of K3's decode (uniform 16-bit patterns, int16 or
        int32) or quantize (N(0, 1), f32 or bf16)."""
        torch = self.torch
        if op == "decode":
            x = torch.randint(0, 1 << 16, shape, generator=g, device=self.dev,
                              dtype=torch.int32)
            return ((x ^ 0x8000) - 0x8000).to(torch.int16) if kind == "int16" else x
        x = torch.randn(shape, generator=g, device=self.dev)
        return x.to(torch.bfloat16) if kind == "bf16" else x

    def time_decode_quantize(self, add, int_rate, ops):
        """K3's decode and quantize (the conformance oracle's calls and the
        prequantized decode) at K3_OTHER_TIMES and K3_OTHER_LANES,
        Posit<16,1>, by time_k3_row; ops: k3_codec_ops'."""
        torch = self.torch
        from repro_torch.kernels.posit_codec import encode_path
        from repro_torch.numerics import P16

        g = self.gen(21)
        rows = []
        for lanes in K3_OTHER_LANES:
            for op, kind in K3_OTHER_TIMES:
                x = self.k3_codec_input(g, op, (lanes,), kind)
                floor_ops = ops["decode" if op == "decode" else encode_path(x.dtype, lanes, P16)]
                rows.append(self.time_k3_row(add, op, x, kind, floor_ops, int_rate))
                del x
        torch.cuda.empty_cache()
        return rows

    def time_train_quantize(self, add, int_rate, ops):
        """K3's quantize at the training paths' shapes (K3_QUANT_TIMES: yi-6b's
        two largest weights, bf16 -> f32, and an activation; the other
        families' new weights), Posit<16,1>, by time_k3_row; ops:
        k3_codec_ops'."""
        torch = self.torch
        from repro_torch.kernels.posit_codec import encode_path
        from repro_torch.numerics import P16

        g = self.gen(23)
        rows = []
        for shape, kind in K3_QUANT_TIMES:
            x = self.k3_codec_input(g, "quantize", shape, kind)
            rows.append(self.time_k3_row(add, "quantize", x, kind,
                                         ops[encode_path(x.dtype, x.numel(), P16)], int_rate,
                                         training=True))
            del x
            torch.cuda.empty_cache()
        return rows

    def k3_criteria(self, rows):
        """The design's aims, read and logged (not gated: two calls may land
        on two cards): each bf16 quantize of K3_QUANT_TIMES at >= 50% of its
        bytes bound and faster than the first form's; decode int16 -> f32
        at 2^24 lanes at >= 60%; the f32 quantize at [1024, 4096] and 2^24
        lanes faster than the first form's."""
        met = {}
        for row in rows:
            name, share, faster = row["shape"], row["bound_share"], row["speedup"] > 1
            if "training" in name and "bf16" in name:
                met[name] = share >= 0.5 and faster
            elif name.startswith(f"decode [{1 << 24}] int16"):
                met[name] = share >= 0.6
            elif (name.startswith(f"quantize [{1 << 24}] f32")
                  or name.startswith("quantize [1024, 4096] f32")):
                met[name] = faster
        log("K3 decode and quantize against the design's aims: "
            + "; ".join(f"{k}: {'met' if v else 'NOT met'}" for k, v in met.items()))
        self.results["k3_criteria"] = met

    def time_by_lane(self):
        """K3's computed paths on both sides of their thresholds of one lane
        a thread (k3_by_lane_max), at K3_BY_LANE_SWEEP: the decode of int16
        and the computed quantize of bf16 and f32, the design beside the
        "by lane" and "by chunk" variants (K3_VARIANTS), raw launches in turns, spun, each output
        equal to the plain version's."""
        torch = self.torch
        from repro_torch.kernels.posit_codec import posit_decode, posit_quantize
        from repro_torch.numerics import P16

        libs, edges = self.k3_variants(), self.k3_by_lane_max()
        names = ("design", "by lane", "by chunk")
        g = self.gen(31)
        rows = []
        for lanes in K3_BY_LANE_SWEEP:
            for op, kind in (("decode", "int16"), ("quantize", "bf16"), ("quantize", "f32")):
                x = self.k3_codec_input(g, op, (lanes,), kind)
                out = torch.empty((lanes,), dtype=torch.float32, device=self.dev)
                want = (posit_decode if op == "decode" else posit_quantize)(
                    x, P16, use_kernel=False)
                calls = {k: self.k3_raw(libs[k], op, x, out) for k in names}
                for k in names:
                    out.fill_(0)
                    calls[k]()
                    self.k3_same(f"{k} {op} {kind} [{lanes}]", out, want)
                turns = self.k3_turns(calls)
                mean = {k: sum(v) / 2 for k, v in turns.items()}
                by_lane = lanes < edges[op]
                rows.append({"op": op, "input": kind, "lanes": lanes, "by_lane": by_lane,
                             "device_ms": turns, "mean_device_ms": mean})
                log(f"  K3 {op} {kind} [{lanes}] ({'one lane' if by_lane else 'chunks'} "
                    f"in the design), spun ms in turns: "
                    + "; ".join(f"{k} {[round(v, 4) for v in vs]}" for k, vs in turns.items()))
                del x, out, want
        self.results["k3_by_lane"] = {"max_lanes": edges, "rows": rows}

    def time_table_edge(self):
        """K3's bf16 quantize on both sides of TABLE_MIN_NUMEL
        (K3_TABLE_EDGE_SHAPES): the table path beside the computed path,
        raw launches in turns, spun, each output equal to the plain
        version's."""
        torch = self.torch
        from repro_torch.kernels.posit_codec import TABLE_MIN_NUMEL, posit_quantize, quantize_table
        from repro_torch.numerics import P16

        lib, table = self.k3_variants()["design"], quantize_table(P16, self.dev)
        g = self.gen(33)
        rows = []
        for shape in K3_TABLE_EDGE_SHAPES:
            x = self.k3_codec_input(g, "quantize", shape, "bf16")
            out = torch.empty(shape, dtype=torch.float32, device=self.dev)
            want = posit_quantize(x, P16, use_kernel=False)
            calls = {"table": self.k3_raw(lib, "quantize", x, out, table),
                     "computed": self.k3_raw(lib, "quantize", x, out)}
            for k, fn in calls.items():
                out.fill_(0)
                fn()
                self.k3_same(f"quantize bf16 {list(shape)} on the {k} path", out, want)
            turns = self.k3_turns(calls)
            taken = "table" if x.numel() >= TABLE_MIN_NUMEL else "computed"
            rows.append({"shape": list(shape), "lanes": x.numel(), "path": taken,
                         "device_ms": turns})
            log(f"  K3 quantize bf16 {list(shape)} ({taken} path in the design), spun ms in "
                f"turns: " + "; ".join(f"{k} {[round(v, 4) for v in vs]}"
                                       for k, vs in turns.items()))
            del x, out, want
        self.results["k3_table_edge"] = rows

    def time_k3_step(self):
        """K3's device time in one posit_quant decode step of mamba2-780m on
        prequantized weights (K3_STEP_CALLS, the calls phase static
        records): each call's raw launch, the design (its path by
        encode_path) beside the first form, in turns, spun, summed over the
        step's calls."""
        torch = self.torch
        from repro_torch.kernels.posit_codec import encode_path, quantize_table
        from repro_torch.numerics import P16

        libs = self.k3_variants()
        g = self.gen(35)
        rows, total = [], {"first form": 0.0, "design": 0.0}
        for op, shape, kind, calls, _ in K3_STEP_CALLS:
            x = self.k3_codec_input(g, op, shape, kind)
            out = torch.empty(shape, dtype=torch.float32, device=self.dev)
            path = "computed" if op == "decode" else encode_path(x.dtype, x.numel(), P16)
            table = quantize_table(P16, self.dev) if path == "table" else None
            turns = self.k3_turns({"first form": self.k3_raw(libs["first form"], op, x, out),
                                   "design": self.k3_raw(libs["design"], op, x, out, table)})
            for k in total:
                total[k] += calls * sum(turns[k]) / 2
            rows.append({"op": op, "shape": list(shape), "input": kind, "calls": calls,
                         "path": path, "device_ms": turns})
            log(f"  K3 step call {op} {kind} {list(shape)} x {calls}, spun ms in turns: "
                + "; ".join(f"{k} {[round(v, 4) for v in vs]}" for k, vs in turns.items()))
            del x, out
        log(f"K3 in one posit_quant mamba2-780m decode step (sum of its calls): design "
            f"{total['design']:.4f} ms, first form {total['first form']:.4f} ms")
        self.results["k3_posit_quant_decode_step"] = {"rows": rows, "device_ms": total}

    def time_table_fill(self):
        """The table fill's share of K3's table paths and the variations
        their design allows: this tree's posit_codec.cu beside the "no
        fill" (its output is garbage; only its time is read), "65536 lanes
        a block" and "two blocks an SM" variants (K3_VARIANTS), raw launches
        of the encode at K3_FILL_SHAPES and of the quantize at
        K3_FILL_QUANT_SHAPES (Posit<16,1>), in turns, spun."""
        torch = self.torch
        from repro_torch.kernels.posit_codec import bf16_table, quantize_table
        from repro_torch.numerics import P16

        libs = self.k3_variants()
        names = ("design", "no fill", "65536 lanes a block", "two blocks an SM")
        g = self.gen(19)
        rows = []
        cases = [("encode", shape, od) for shape, od in K3_FILL_SHAPES]
        cases += [("quantize", shape, "float32") for shape in K3_FILL_QUANT_SHAPES]
        for op, shape, od_name in cases:
            x = self.k3_input(g, shape, "bf16")
            out = torch.empty(shape, dtype=getattr(torch, od_name), device=self.dev)
            table = (bf16_table if op == "encode" else quantize_table)(P16, self.dev)
            turns = self.k3_turns({k: self.k3_raw(libs[k], op, x, out, table) for k in names},
                                  reps=30)
            design = sum(turns["design"]) / 2
            share = (design - sum(turns["no fill"]) / 2) / design
            rows.append({"op": op, "shape": list(shape), "out": od_name, "device_ms": turns,
                         "fill_share": share})
            log(f"  table probe {op} {list(shape)} bf16->{od_name}, spun ms in turns: "
                + "; ".join(f"{k} {[round(v, 4) for v in vs]}" for k, vs in turns.items())
                + f"; fill share {share:.3f}")
            del x, out
        torch.cuda.empty_cache()
        self.results["k3_table_fill"] = rows

    def time_posit_mul(self, add, int_rate):
        """K4 over 2^24 seeded Posit<16,1> pairs: 12 bytes a lane, and the
        ALU-pipe operations a lane needs at 64 lanes per SM per clock (the
        hand count in posit_mul.cu); no library call computes it."""
        torch = self.torch
        from repro_torch.kernels.posit_codec import (
            exact_mul_elementwise,
            plam_mul_elementwise,
        )
        from repro_torch.numerics import P16

        g = self.gen(6)
        lanes = 1 << 24
        a = torch.randint(0, 1 << 16, (lanes,), generator=g, device=self.dev,
                          dtype=torch.int32)
        b = torch.randint(0, 1 << 16, (lanes,), generator=g, device=self.dev,
                          dtype=torch.int32)
        with open(K4_SOURCE) as f:
            src = f.read()
        ops = {name: int(re.search(rf"constexpr int {const} = (\d+);", src).group(1))
               for name, const in K4_OPS.items()}
        log(f"K4 ALU-pipe operations a lane needs (counted in posit_mul.cu): {ops}")
        rows = []
        for fn in (plam_mul_elementwise, exact_mul_elementwise):
            ms = self.timed(lambda: fn(a, b, P16), reps=20)
            plain = self.events_ms(lambda: fn(a, b, P16, use_kernel=False), reps=2, warmup=1)
            rows.append(add("posit_mul", f"{fn.__name__} Posit<16,1> 2^24 lanes", ms, plain,
                            12 * lanes, ops[fn.__name__] * lanes, int_rate))
        # a conformance-sized call (2^20 lanes): launch and tail
        a20, b20 = a[: 1 << 20], b[: 1 << 20]
        ms = self.timed(lambda: plam_mul_elementwise(a20, b20, P16), reps=20)
        plain = self.events_ms(lambda: plam_mul_elementwise(a20, b20, P16, use_kernel=False),
                               reps=2, warmup=1)
        add("posit_mul", "plam_mul_elementwise Posit<16,1> 2^20 lanes", ms, plain,
            12 << 20, ops["plam_mul_elementwise"] << 20, int_rate)
        return rows[0]

    def time_decode_attention(self, add):
        """K5 at yi-6b's widths, bf16, beside scaled_dot_product_attention
        on the same cache laid out [B, kv, S, hd] with a boolean length mask
        (timed as the yardstick only; the port never calls it).  The bound
        counts the live keys: each K/V row below its sequence's length read
        once."""
        torch = self.torch
        from repro_torch.kernels.decode_attention import card_sms, decode_attention, split_plan

        g = self.gen(8)
        sh = K5_SHAPE
        b, h, kv, hd, s = sh["b"], sh["h"], sh["kv"], sh["hd"], sh["s"]
        q = torch.randn((b, h, hd), generator=g, device=self.dev).to(torch.bfloat16)
        k = torch.randn((b, s, kv, hd), generator=g, device=self.dev).to(torch.bfloat16)
        v = torch.randn((b, s, kv, hd), generator=g, device=self.dev).to(torch.bfloat16)
        lens = torch.tensor(K5_LENGTHS, dtype=torch.int32, device=self.dev)
        ms = self.timed(lambda: decode_attention(q, k, v, lens), reps=50)
        plain = self.events_ms(lambda: decode_attention(q, k, v, lens, use_kernel=False),
                               reps=10)
        kc, vc = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        lib_ms = self.timed(self.sdpa(q, kc, vc, lens), reps=50)
        live = sum(K5_LENGTHS)
        bytes_ = 2 * q.numel() * 2 + 2 * live * kv * hd * 2 + b * 4
        # the split plan's choice beside other split sizes (the kernel's
        # blk: keys a block covers), spun
        plan = split_plan(b, kv, s, card_sms(torch.cuda.current_device()))
        sweep = {}
        for blk in K5_SPLIT_SWEEP:
            sweep[blk] = self.events_ms(lambda: decode_attention(q, k, v, lens, blk=blk), 50,
                                        spin=True)
        log(f"K5 split sweep (keys a block, spun ms; the plan takes {plan.split_keys}): "
            + ", ".join(f"{blk} {ms:.4f}" for blk, ms in sweep.items()))
        self.results["k5_split_sweep"] = {"plan": plan.split_keys, "device_ms": sweep}
        return add("decode_attention", f"B={b} H={h} kv={kv} hd={hd} S={s} bf16 "
                   f"lens={K5_LENGTHS}", ms, plain, bytes_, 4 * live * h * hd, F32_FLOPS,
                   library_ms=lib_ms)

    # -- phase 14 ------------------------------------------------------------

    def phase_dryrun(self):
        """The dry run, the op analysis and the roofline held against the
        card: each cell's step measured here, then dry-run on meta."""
        torch = self.torch
        import gc

        failures, rows = [], {}
        self.yi_model = None  # the earlier phases' model
        for arch, fields, policy, prequantized, layers in DRYRUN_CELLS:
            gc.collect()
            torch.cuda.empty_cache()
            row = self.dryrun_cell(arch, fields, policy, prequantized, layers, failures)
            rows[f"{arch} {fields[0]}"] = row
        self.results["dryrun"] = {"card": self.results["device"]["nvidia_smi"],
                                  "tf32": torch.backends.cuda.matmul.allow_tf32, "cells": rows}
        if failures:
            raise AssertionError("; ".join(failures[:8]))

    def dryrun_cell(self, arch, fields, policy, prequantized, layers, failures) -> dict:
        """One cell: built on the card from the seeded init, run once, timed
        over DRYRUN_STEPS steps (launches and peak memory read), then the
        same step dry-run on meta and its roofline row."""
        torch = self.torch
        import gc

        import numpy as np

        from repro_torch.configs import ShapeSpec, get_config
        from repro_torch.kernels import _lib
        from repro_torch.launch import dryrun, roofline

        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=min(layers, self.args.layers))
        if policy:
            cfg = cfg.with_numerics(policy)
        shape = ShapeSpec(*fields)
        name = f"{arch} {shape.kind} ({shape.global_batch} x {shape.seq_len}, "
        name += f"{cfg.n_layers} layers{', prequantized' if prequantized else ''})"
        base = torch.cuda.memory_allocated()
        step, args = dryrun.build_cell(cfg, shape, device=self.dev, prequantize=prequantized)
        step(*args)  # the warm-up: the K3 tables a step needs are built here
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, per_step = [], []
        for _ in range(DRYRUN_STEPS):
            _lib.reset_launches()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            per_step.append({k: v for k, v in _lib.launches.items() if v})
            del out
        measured_peak = torch.cuda.max_memory_allocated() - base
        del step, args
        gc.collect()
        torch.cuda.empty_cache()
        step_s = float(np.median(times))

        # the same step on meta: a warm-up (the meta device's K3 tables, as
        # the card's were built above), then the traced step
        t0 = time.perf_counter()
        rec, _ = dryrun.analyze_cell(cfg, shape, prequantize=prequantized, warmup=True)
        dry_s = time.perf_counter() - t0
        row = roofline.roofline_row(rec, cfg, shape)
        predicted = rec["memory"]["peak_bytes"]
        mem_err = (predicted - measured_peak) / measured_peak
        share = row["t_bound_s"] / step_s
        res = {"step_s": times, "step_p50_s": step_s, "launches": per_step[0],
               "dry_launches": rec["launches"], "measured_peak_bytes": measured_peak,
               "predicted_peak_bytes": predicted, "memory": rec["memory"],
               "predicted_over_measured": predicted / measured_peak,
               "t_compute_s": row["t_compute_s"], "t_memory_s": row["t_memory_s"],
               "t_collective_s": row["t_collective_s"], "dominant": row["dominant"],
               "t_bound_s": row["t_bound_s"], "t_ideal_s": row["t_ideal_s"],
               "bound_over_step": share, "roofline_fraction": row["t_ideal_s"] / step_s,
               "flops_by_class": rec["flops_by_class"], "int_ops": rec["int_ops"],
               "elem_ops": rec["elem_ops"], "bytes_accessed": rec["bytes_accessed"],
               "mode": row["mode"], "dry_run_s": dry_s}
        log(f"dryrun {name}: step p50 {step_s * 1e3:.2f} ms (steps "
            + ", ".join(f"{t * 1e3:.2f}" for t in times) + f" ms); bound "
            f"{row['t_bound_s'] * 1e3:.3f} ms ({row['dominant']}: compute "
            f"{row['t_compute_s'] * 1e3:.3f}, memory {row['t_memory_s'] * 1e3:.3f} ms) = "
            f"{share:.3f} of the step; ideal {row['t_ideal_s'] * 1e3:.3f} ms ({row['mode']}) "
            f"= roofline fraction {row['t_ideal_s'] / step_s:.4f}; peak memory predicted "
            f"{predicted / 2**30:.3f} GiB, measured {measured_peak / 2**30:.3f} GiB "
            f"({mem_err:+.4f}); launches {per_step[0]} (dry run {rec['launches']}); "
            f"dry run {dry_s:.1f} s; {self.results['device']['nvidia_smi']}")
        if any(c != per_step[0] for c in per_step):
            failures.append(f"{name}: launches differ between steps: {per_step}")
        if per_step[0] != rec["launches"]:
            failures.append(f"{name}: launches {per_step[0]} but the dry run's "
                            f"{rec['launches']}")
        if abs(mem_err) > DRYRUN_MEM_TOL:
            failures.append(f"{name}: predicted peak {predicted / 2**30:.3f} GiB is "
                            f"{mem_err:+.3f} of the measured {measured_peak / 2**30:.3f}")
        if share > DRYRUN_BOUND_SLACK:
            failures.append(f"{name}: the bound {row['t_bound_s'] * 1e3:.3f} ms is "
                            f"{share:.3f} of the measured step")
        return res

    # -- phase 15 ------------------------------------------------------------

    def phase_tp(self):
        """Tensor-parallel serving, each world spawned from here
        (``launch/mesh.py::spawn``): yi-6b at full width cut to TP_YI_LAYERS
        at tp = 2 (plain, then chunked prefill with n-gram spec), yi-6b cut
        in depth at tp = 8 (the replicated-kv-head fallback),
        granite-moe-1b-a400m and deepseek-moe-16b cut in depth at tp = 2,
        and yi-6b at TP_YI_LAYERS at tp = 1 in a world of one over nccl.  Every world but the
        last runs its ranks over gloo on this one card."""
        torch = self.torch
        import gc

        from repro_torch.launch.mesh import spawn

        self.yi_model = None
        gc.collect()
        torch.cuda.empty_cache()
        card = self.results["device"]["nvidia_smi"]
        note = f"[{card}; every rank on this one card: not multi-card figures]"
        failures, res = [], {"card": card}
        layers = min(self.args.layers, TP_YI_LAYERS)
        base = dict(max_new_tokens=16, block_size=16, max_slots=4, num_blocks=64,
                    max_seq_len=128, prequantize=True)
        cfg = self.yi_cfg(layers)
        prompts, want, ref = self.tp_reference(cfg, base)
        res["tp1_step_p50_s"] = ref["step_p50_s"]

        def world(name, tp, job, want, cfg, model_of, prompts, want_events=None):
            """One spawned world: its ranks' gates, then rank 0's tokens
            against the tp = 1 run's under the serve-paths margin rule (a
            MoE's: where its routing calls and token picks first part from
            the tp = 1 run's, a router top-k margin below MOE_ROUTE_TOL or a
            top-2 logit margin below E2E_LOGIT_TOL, as phase
            train_families holds the trained MoE)."""
            t0 = time.perf_counter()
            ranks = spawn(tp_rank, tp, "cuda", self.args, job, timeout=TP_TIMEOUT_S)
            row = {"seconds": time.perf_counter() - t0, "ranks": ranks}
            res[name] = row
            r0 = ranks[0]
            for r in ranks:
                failures.extend(f"{name} rank {r['rank']}: {f}" for f in r["failures"])
                for run, out in r["outputs"].items():
                    if out != r0["outputs"][run]:
                        failures.append(f"{name} rank {r['rank']}: {run} tokens differ from "
                                        f"rank 0's")
            log(f"tp {name}: backend {r0['backend']}, world {r0['world']}, peak per rank "
                f"{[round(r['peak_gib'], 3) for r in ranks]} GiB, step p50 "
                + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in r0["step_p50_s"].items())
                + f", {row['seconds']:.1f} s with the spawn {note}")
            for run, out in r0["outputs"].items():
                if want_events is not None:
                    # a routing call may part where two experts' probabilities
                    # lie within twice the largest move of any probability so
                    # far (each moved by at most that), that move below
                    # MOE_ROUTE_TOL; a token pick by the margin rule
                    diffs, moved = self.first_departure(r0["events"], want_events, cfg.top_k)
                    row["router_prob_perturbation"] = moved
                    bad = [d for d in diffs if (
                        d["event"] == "route" and not (moved < MOE_ROUTE_TOL and
                                                       d["router_swap_margin"] <= 2 * moved))
                        or d.get("plain_top2_margin", 0.0) >= E2E_LOGIT_TOL
                        or d["event"] == "structure"]
                    if diffs:
                        log(f"  {name}: router probabilities' largest |difference| from tp = 1 "
                            f"up to where they part {moved:.3e}")
                else:
                    diffs = [] if out == want else self.token_diffs(cfg, model_of(), prompts,
                                                                    out, want)
                    bad = [d for d in diffs if d["plain_top2_margin"] >= E2E_LOGIT_TOL]
                row.setdefault("token_diffs", {})[run] = diffs
                failures.extend(f"{name} {run}: parts from tp = 1 at {d}" for d in bad)
                log(f"  {name} {run}: greedy tokens "
                    + ("equal to the tp = 1 run's" if out == want else "differ from the tp = 1 "
                       f"run's; where the runs first part: {diffs}"))
            r0.pop("events", None)
            return r0

        # a. yi-6b, full width and depth, tp = 2
        job = dict(arch="yi-6b", layers=layers, tp=2, prompts=prompts, base=base,
                   runs={"plain": {}, "chunk_spec": {"prefill_chunk": SERVE_CHUNK,
                                                     "spec_k": SERVE_SPEC_K}},
                   k1_shapes=TP_YI_K1, check_k2=True, time_k1=True, collectives=True)
        r0 = world("yi-6b tp=2", 2, job, want, cfg, ref["model"], prompts)
        ref["model"].cache_clear()
        res["step_p50_s"] = {"tp1": ref["step_p50_s"], "tp2": r0["step_p50_s"]["plain"]}
        log(f"tp yi-6b step p50: tp = 1 {ref['step_p50_s'] * 1e3:.1f} ms, tp = 2 "
            f"{r0['step_p50_s']['plain'] * 1e3:.1f} ms; collectives "
            f"{r0['collectives']['decode_share']:.3f} of a decode step "
            f"({r0['collectives']['per_decode_step']} a step) {note}")
        # b. yi-6b cut in depth at tp = 8: kv = 4 < 8, the replicated-kv-head
        # fallback
        cut = self.yi_cfg(min(layers, TP_CUT_LAYERS))
        cut_ref = self.tp_model_run("yi-6b", cut.n_layers, base, prompts)
        job = dict(arch="yi-6b", layers=cut.n_layers, tp=TP_FALLBACK, prompts=prompts,
                   base=base, runs={"plain": {}}, layout="replicated_kv_heads")
        world(f"yi-6b tp={TP_FALLBACK} {cut.n_layers} layers", TP_FALLBACK, job,
              cut_ref["outputs"], cut, cut_ref["model"], prompts)
        del cut_ref
        # c. the MoE family at tp = 2 (granite's vocab of 49,155 kept whole),
        # both cut in depth
        for arch, depth in (("granite-moe-1b-a400m", TP_CUT_LAYERS),
                            ("deepseek-moe-16b", TP_CUT_LAYERS)):
            mcfg = self.moe_cfg(arch)
            depth = min(depth or mcfg.n_layers, layers)
            _, mprompts = self.moe_prompts(mcfg.vocab)
            mref = self.tp_model_run(arch, depth, base, mprompts)
            job = dict(arch=arch, layers=depth, tp=2, prompts=mprompts, base=base,
                       runs={"plain": {}}, layout="kv_heads", check_k1=True)
            world(f"{arch} tp=2 {depth} layers", 2, job, mref["outputs"],
                  dataclasses.replace(mcfg, n_layers=depth), mref["model"], mprompts,
                  mref["events"])
            del mref
            gc.collect()
            torch.cuda.empty_cache()
        # d. yi-6b at tp = 1 in a world of one: the nccl path
        job = dict(arch="yi-6b", layers=layers, tp=1, prompts=prompts, base=base,
                   runs={"plain": {}}, backend="nccl")
        world("yi-6b tp=1 nccl", 1, job, want, cfg, ref["model"], prompts)
        ref["model"].cache_clear()
        self.results["tp"] = res
        if failures:
            raise AssertionError("; ".join(failures[:8]))

    def tp_reference(self, cfg, base):
        """Phase serve's prompts and tokens at tp = 1 (served here when that
        phase did not run), with its step p50 and the tp = 1 model made on
        demand (for the margin of a token that differs)."""
        import functools

        from repro_torch.core.prequant import quantize_params
        from repro_torch.models import transformer as tf

        serve = self.results.get("serve", {})
        if serve.get("layers") == cfg.n_layers and getattr(self, "serve_prompts", None):
            prompts, want = self.serve_prompts, serve["outputs"]
            p50 = serve["run_step_p50_s"]
        else:
            g = self.torch.Generator().manual_seed(7)  # the serve phase's requests
            lens = self.torch.randint(32, 65, (4,), generator=g).tolist()
            prompts = [self.torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
                       for n in lens]
            run = self.tp_model_run("yi-6b", cfg.n_layers, base, prompts)
            want, p50 = run["outputs"], run["step_p50_s"]

        @functools.lru_cache(maxsize=1)
        def model():
            m = tf.lm_init(cfg, seed=0, device=self.dev)
            quantize_params(cfg, m)
            return m

        return prompts, want, {"step_p50_s": p50, "model": model}

    def tp_model_run(self, arch, layers, base, prompts):
        """``arch`` at full width and ``layers`` deep from the seeded init,
        prequantized, served at tp = 1 here: its tokens, step p50, the
        model (for the margins) and, for a MoE, its routing calls and
        token picks (``recording_serve_events``)."""
        from repro_torch.core.prequant import quantize_params
        from repro_torch.models import transformer as tf
        from repro_torch.serving import ServeOptions

        cfg = tp_cfg(arch, layers)
        model = tf.lm_init(cfg, seed=0, device=self.dev)
        quantize_params(cfg, model)
        with self.recording_serve_events() as events:
            run = self.serve_run(f"{arch} tp=1 {layers} layers", cfg, model,
                                 ServeOptions(**base), prompts)
        return {"outputs": run["outputs"], "step_p50_s": run["step_p50_s"],
                "model": lambda: model, "events": events if cfg.n_experts else None}

    def phase_tp_train(self):
        """Training over a (data x model) mesh of ranks, one world spawned
        from here (``launch/mesh.py::spawn``), its four ranks sharing this
        card over gloo: yi-6b at TP_TRAIN_LAYERS layers and phase train's settings
        (TP_TRAIN_STEPS steps; tensor parallelism over model, the global
        batch over data, ZeRO-1 AdamW state) with a checkpoint of whole
        leaves after TP_TRAIN_CKPT_AFTER, TP_TRAIN_MOE at full width cut to
        TP_TRAIN_MOE_LAYERS, and yi-6b at TP_TRAIN_EXACT_LAYERS layers in f32 against a
        one-rank step (``Smoke.tp_train_steps``, ``Smoke.tp_train_exact``);
        then the checkpoint restored on one rank here, which takes the
        remaining steps (elastic restore, 2 x 2 -> 1 x 1).  Where the
        machine has a card a rank, the world runs over nccl, and yi-6b also
        trains at its full depth (``yi_full``: steps only, no checkpoint, at
        TP_TRAIN_FULL_LR)."""
        torch = self.torch
        import gc
        import shutil

        from repro_torch.configs import get_config
        from repro_torch.core.policy import describe
        from repro_torch.launch.mesh import choose_backend, spawn

        self.yi_model = None
        gc.collect()
        torch.cuda.empty_cache()
        card = self.results["device"]["nvidia_smi"]
        data, tp = TP_TRAIN_MESH
        backend = choose_backend(data * tp, "cuda")
        cards = torch.cuda.device_count()
        note = (f"[{card}; the ranks share this one card over gloo: not multi-card figures]"
                if backend == "gloo" else f"[{cards} x {card}, a card a rank over nccl]")
        yi = dataclasses.replace(self.train_cfg(),
                                 n_layers=min(self.args.layers, TP_TRAIN_LAYERS))
        moe = get_config(TP_TRAIN_MOE)
        moe = dataclasses.replace(moe, n_layers=min(self.args.layers, TP_TRAIN_MOE_LAYERS))
        exact = dataclasses.replace(get_config("yi-6b"), n_layers=TP_TRAIN_EXACT_LAYERS,
                                    param_dtype="float32", act_dtype="float32")
        ckpt_dir = os.path.join(ROOT, "build", "tp_train_ckpt")
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        failures, res = [], {"card": card, "mesh": {"data": data, "model": tp}}
        want0 = {"yi": self.tp_train_loss0(yi, "train", "yi"),
                 "moe": self.tp_train_loss0(moe, "train_families", TP_TRAIN_MOE)}
        jobs = {"yi": dict(kind="steps", cfg=yi, steps=TP_TRAIN_STEPS,
                           ckpt_after=TP_TRAIN_CKPT_AFTER, ckpt_dir=ckpt_dir, count=True),
                "moe": dict(kind="steps", cfg=moe, steps=TP_TRAIN_MOE_STEPS),
                "exact": dict(kind="exact", cfgs={
                    k: (exact.with_numerics(pol), tol)
                    for k, (pol, tol) in TP_TRAIN_EXACT_POLICIES.items()})}
        if backend == "nccl":  # a card a rank: room for all 32 layers
            full = dataclasses.replace(yi, n_layers=get_config("yi-6b").n_layers)
            jobs["yi_full"] = dict(kind="steps", cfg=full, steps=TP_TRAIN_STEPS, count=True,
                                   lr=TP_TRAIN_FULL_LR)
            want0["yi_full"] = self.tp_train_loss0(full, "train", "yi")
        for job in jobs.values():
            job.update(data=data, model=tp)
        log(f"tp_train: a world of {data * tp} ranks, (data {data} x model {tp}) over {backend} "
            f"on {cards} card(s); yi-6b {yi.n_layers} of 32 layers ({describe(yi.numerics)!r}), "
            f"{TP_TRAIN_MOE} {moe.n_layers} layers, yi-6b {exact.n_layers} layers f32"
            + (", yi-6b 32 layers" if "yi_full" in jobs else ""))
        cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # the ranks' deterministic cuBLAS
        t0 = time.perf_counter()
        try:
            ranks = spawn(tp_train_rank, data * tp, "cuda", self.args, jobs,
                          timeout=TP_TRAIN_TIMEOUT_S)
        finally:
            if cublas is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
        res["world_s"] = time.perf_counter() - t0
        r0 = ranks[0]
        res["backend"], res["world"] = r0["backend"], r0["world"]
        log(f"tp_train: backend {r0['backend']}, world {r0['world']}, ranks "
            f"{[r['rank'] for r in ranks]} at (data, model) "
            f"{[(r['data_rank'], r['model_rank']) for r in ranks]}; the world in "
            f"{res['world_s']:.1f} s with the spawn {note}")
        if r0["backend"] != backend or r0["world"] != data * tp:
            failures.append(f"world {r0['world']} over {r0['backend']}, not {data * tp} over "
                            f"{backend}")
        for name in [n for n in ("yi", "moe", "yi_full") if n in jobs]:
            res[name] = self.tp_train_gates(name, jobs[name]["cfg"], ranks, want0[name], failures,
                                            note)
        res["exact"] = {name: [r["exact"][name] for r in ranks] for name in r0["exact"]}
        for name, per_rank in res["exact"].items():
            ex = per_rank[0]
            for r, got in zip(ranks, per_rank):
                failures.extend(f"exact {name} rank {r['rank']}: {f}" for f in got["failures"])
            worst = {k: max(x[k] for x in per_rank)
                     for k in ("max_param_diff", "max_m_diff", "max_v_diff", "loss_rel_diff")}
            log(f"tp_train exact {name} (yi-6b {exact.n_layers} layers, f32 parameters and "
                f"activations, AdamW eps {TP_TRAIN_EXACT_EPS}, deterministic algorithms; each "
                f"rank's slices against one rank's step): loss {ex['loss']:.6f} against one "
                f"rank's {ex['one_rank_loss']:.6f} ({worst['loss_rel_diff']:.2e}); largest "
                f"|difference| of a parameter {worst['max_param_diff']:.3e} (tolerance "
                f"{ex['param_tol']:.0e}), of m {worst['max_m_diff']:.3e}, of v "
                f"{worst['max_v_diff']:.3e} over {ex['leaves']} leaves; the sharded step "
                f"{ex['step_s']:.2f} s; K3 at {ex['k3_shapes']} (shape, dtype) "
                f"{'bit-identical' if not ex['k3_differ'] else ex['k3_differ']}")
        res["restore"] = self.tp_train_restore(yi, ckpt_dir, r0["yi"]["losses"], failures, note)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        k3 = sum(sum(r["yi"]["k3"]) + sum(r["moe"]["k3"]) for r in ranks[:1])
        self.path_launches["posit_codec"] = self.path_launches.get("posit_codec", 0) + k3
        self.results["tp_train"] = res
        if failures:
            raise AssertionError("; ".join(failures[:8]))

    def tp_train_loss0(self, cfg, phase, key):
        """One rank's step-0 loss of ``cfg``'s seeded init on batch 0: phase
        ``phase``'s where it trained the same depth, else a no-grad forward
        here."""
        from repro_torch.models import build

        got = self.results.get(phase, {})
        got = got.get("models", got).get(key)
        if got is not None and got.get("layers") == cfg.n_layers:
            return {"loss": got["losses"][0], "from": f"phase {phase}"}
        api = build(cfg)
        model = api.init(seed=0, device=self.dev)
        with self.torch.no_grad():
            loss = float(api.train_loss(model, self.family_batch(api, cfg, TRAIN_BATCH,
                                                                 TRAIN_SEQ, 0)))
        del model
        self.torch.cuda.empty_cache()
        return {"loss": loss, "from": "a one-rank forward here"}

    def tp_train_gates(self, name, cfg, ranks, want0, failures, note):
        """Phase tp_train's gates on one model's steps, every rank's."""
        import numpy as np

        r0 = ranks[0][name]
        row = {"ranks": [r[name] for r in ranks], "step0_reference": want0}
        for r in ranks:
            got = r[name]
            failures.extend(f"{name} rank {r['rank']}: {f}" for f in got["failures"])
            if got["losses"] != r0["losses"]:
                failures.append(f"{name} rank {r['rank']}: losses {got['losses']} differ from "
                                f"rank 0's {r0['losses']}")
        losses = r0["losses"]
        rel0 = abs(losses[0] - want0["loss"]) / abs(want0["loss"])
        row["step0_rel_diff"] = rel0
        if not rel0 <= TP_TRAIN_LOSS_RTOL:
            failures.append(f"{name}: step-0 loss {losses[0]} against one rank's "
                            f"{want0['loss']} ({want0['from']}): {rel0:.2e} > "
                            f"{TP_TRAIN_LOSS_RTOL}")
        # falling: batch 0's loss after the steps below its step-0 loss (the
        # batches differ, so one step's loss may lie above another's)
        if not all(np.isfinite(losses)) or not r0["batch0_after"] < losses[0]:
            failures.append(f"{name}: losses {losses}, batch 0's {r0['batch0_after']} after "
                            f"them: not finite and falling")
        p50 = float(np.quantile(r0["step_s"][1:], 0.5))
        row["step_p50_s"] = p50
        log(f"tp_train {name} ({cfg.name}, {cfg.n_layers} layers, AdamW lr {r0['lr']}): losses "
            f"{[round(x, 4) for x in losses]}, batch 0's {r0['batch0_after']:.4f} after them "
            f"(step 0 {rel0:.2e} from one rank's "
            f"{want0['loss']:.4f}, {want0['from']}); step seconds "
            f"{[round(x, 3) for x in r0['step_s']]}, p50 over steps 1+ {p50:.3f} s; init "
            f"{r0['init_s']:.1f} s; peak per rank {[round(r[name]['peak_gib'], 2) for r in ranks]} "
            f"GiB; m + v a rank {[r[name]['state_bytes'] for r in ranks]} bytes (ZeRO-1's "
            f"per-device count {r0['state_bytes_want']}) {note}")
        log(f"  K3 posit_quantize a step per rank {[r[name]['k3'] for r in ranks]} (hand count "
            f"{r0['k3_want']}; a no-grad forward {r0['k3_forward']}, hand count "
            f"{r0['k3_forward_want']}); plain calls on the card {r0['plain_calls']}; rank 0's K3 "
            f"at {len(r0['k3_seen'])} (shape, dtype): "
            f"{[(s['shape'], s['dtype'], s['launches']) for s in r0['k3_seen']]}")
        if r0.get("collectives_want") is not None:
            log(f"  collectives a step (rank 0) {r0['collectives']} (hand count "
                f"{r0['collectives_want']}); the last step's collectives, the card synchronized "
                f"around each, {r0['collective_s']:.3f} s of its {r0['step_s'][-1]:.3f} s: "
                f"{r0['collective_s'] / r0['step_s'][-1]:.3f}")
        if r0.get("ckpt_s") is not None:
            log(f"  checkpoint after step {TP_TRAIN_CKPT_AFTER}: whole leaves gathered and "
                f"written by rank 0 in {r0['ckpt_s']:.1f} s ({r0['ckpt_bytes'] / 1e9:.2f} GB)")
        return row

    def tp_train_steps(self, job, mesh):
        """One rank's steps of ``job["cfg"]`` over ``mesh`` from the sharded
        seeded init at phase train's settings: each step's loss, seconds
        and K3 quantizes (against ``family_quantize_count``, confirmed by a
        no-grad forward of this rank's rows), no plain codec call on the
        card, K3 bit for bit at each (shape, dtype) rank 0 launched, the
        rank's ZeRO-1 state bytes against the per-device count of
        ``zero1_dims`` on the stacked leaves, peak memory; with ``count``,
        the collectives a step against ``tp_train_collectives`` and the
        last step's collectives timed; with ``ckpt_after``, the whole
        leaves gathered and written by rank 0 after that many steps."""
        torch = self.torch
        from repro_torch.kernels import _lib
        from repro_torch.models import build
        from repro_torch.models.transformer import set_trainable
        from repro_torch.optim.optimizers import OptConfig, Zero1, init_state, zero1_dims, \
            zero1_numel
        from repro_torch.parallel.sharding import leaf_layouts, use_mesh
        from repro_torch.train import checkpoint as ckpt_lib
        from repro_torch.train.loop import (
            TrainConfig,
            gather_train_tree,
            local_rows,
            make_train_step,
        )

        cfg, rank = job["cfg"], mesh.rank
        api = build(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = set_trainable(api.init(seed=0, device=self.dev, mesh=mesh))
        zero = Zero1(leaf_layouts(cfg, mesh), mesh)
        tcfg = TrainConfig(opt=OptConfig(name="adamw", lr=job.get("lr", TRAIN_LR)))
        state = init_state(tcfg.opt, model, zero)
        step = make_train_step(api.train_loss, tcfg, zero)
        torch.cuda.synchronize()
        fwd_k3, want_k3 = self.family_quantize_count(cfg, TRAIN_SEQ)
        want_bytes = 0
        for names in zero.by_path.values():
            lay = zero.layouts[names[0]]
            shape = ((cfg.n_layers,) if lay.layer is not None else ()) + lay.shape
            want_bytes += 8 * zero1_numel(shape, zero1_dims(lay.path, shape, mesh), mesh)
        out = {"init_s": time.perf_counter() - t0, "losses": [], "step_s": [], "k3": [],
               "lr": tcfg.opt.lr,
               "failures": [], "state_bytes": zero.state_bytes(state),
               "state_bytes_want": want_bytes, "k3_want": want_k3, "k3_forward_want": fwd_k3,
               "collectives_want": (tp_train_collectives(cfg, zero, model) if job.get("count")
                                    else None),
               "ckpt_s": None}
        fails = out["failures"]
        if out["state_bytes"] != want_bytes:
            fails.append(f"m + v {out['state_bytes']} bytes, ZeRO-1's count {want_bytes}")
        batch0 = self.family_batch(api, cfg, TRAIN_BATCH, TRAIN_SEQ, 0)
        with contextlib.ExitStack() as stack:
            seen = stack.enter_context(self.recording_k3()) if rank == 0 else {}
            plain = stack.enter_context(self.counting_plain())
            for i in range(job["steps"]):
                batch = batch0 if i == 0 else self.family_batch(api, cfg, TRAIN_BATCH,
                                                                TRAIN_SEQ, i)
                mesh.time_collectives = bool(job.get("count")) and i == job["steps"] - 1
                mesh.traffic.clear()
                mesh.collective_s = 0.0
                torch.cuda.synchronize()
                _lib.reset_launches()
                t0 = time.perf_counter()
                loss = float(step(model, state, batch)[2]["loss"])
                torch.cuda.synchronize()
                out["step_s"].append(time.perf_counter() - t0)
                out["losses"].append(loss)
                out["k3"].append(_lib.launches["posit_codec"])
                out["collectives"] = dict(mesh.collectives)
                out["collective_s"] = mesh.collective_s
                log(f"  {cfg.name} step {i}: loss {loss:.4f}, {out['step_s'][-1]:.3f} s, K3 "
                    f"{out['k3'][-1]}, collectives {out['collectives']}")
                if job.get("ckpt_after") == i + 1:
                    t0 = time.perf_counter()
                    tree = gather_train_tree(model, state, zero)
                    if tree is not None:
                        ckpt_lib.save(job["ckpt_dir"], i + 1, tree)
                        out["ckpt_bytes"] = sum(t.numel() * t.element_size()
                                                for t in ckpt_lib._flatten(tree)[0])
                        del tree
                    mesh.barrier()
                    out["ckpt_s"] = time.perf_counter() - t0
            mesh.time_collectives = False
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            with torch.no_grad(), use_mesh(mesh):
                _lib.reset_launches()
                after = api.train_loss(model, local_rows(batch0, mesh))
                out["k3_forward"] = _lib.launches["posit_codec"]
            # this rank's share of batch 0's loss (its label count the global batch's)
            out["batch0_after"] = float(mesh.all_reduce(after, "data"))
        out["plain_calls"] = dict(plain)
        out["k3_seen"] = list(seen.values())
        if any(n != want_k3 for n in out["k3"]) or out["k3_forward"] != fwd_k3:
            fails.append(f"K3 launches {out['k3']}, forward {out['k3_forward']}; expected "
                         f"{want_k3} and {fwd_k3}")
        if any(plain.values()):
            fails.append(f"plain calls on the card {dict(plain)}")
        differ = [s for s in seen.values() if s["lanes_differ"]]
        if differ or (rank == 0 and not seen):
            fails.append(f"K3 quantize differs from its plain version: {differ}")
        if out["collectives_want"] is not None and out["collectives"] != out["collectives_want"]:
            fails.append(f"collectives a step {out['collectives']}, hand count "
                         f"{out['collectives_want']}")
        del model, state, step
        return out

    def tp_train_exact(self, job, mesh):
        """For each of ``job["cfgs"]`` (f32 parameters and activations; its
        parameters' tolerance beside it): one sharded step under
        deterministic algorithms, AdamW at eps TP_TRAIN_EXACT_EPS; then each
        rank in turn (the others waiting) takes one rank's step of the same
        init and batch and holds its own slices of every parameter, m and v
        against that step's: the loss within TP_TRAIN_EXACT_TOL (relative),
        each parameter within the tolerance, m and v within
        TP_TRAIN_EXACT_MOMENT_ATOL + TP_TRAIN_EXACT_TOL |one rank's|.  The
        ranks' slices cover every element.  K3 bit for bit at each (shape,
        dtype) rank 0 launched."""
        torch = self.torch
        det = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            return {name: self.tp_train_exact_one(cfg, tol, mesh)
                    for name, (cfg, tol) in job["cfgs"].items()}
        finally:
            torch.use_deterministic_algorithms(det)

    def tp_train_exact_one(self, cfg, param_tol, mesh):
        torch = self.torch
        import gc

        from repro_torch.models import build
        from repro_torch.models.transformer import set_trainable
        from repro_torch.optim.optimizers import OptConfig, Zero1, init_state, named_params
        from repro_torch.parallel.sharding import leaf_layouts
        from repro_torch.train.loop import TrainConfig, make_train_step

        rank = mesh.rank
        api = build(cfg)
        tcfg = TrainConfig(opt=OptConfig(name="adamw", lr=TRAIN_LR, eps=TP_TRAIN_EXACT_EPS))
        batch = self.family_batch(api, cfg, TRAIN_BATCH, TRAIN_SEQ, 0)
        out = {"failures": [], "param_tol": param_tol}
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            seen = stack.enter_context(self.recording_k3()) if rank == 0 else {}
            model = set_trainable(api.init(seed=0, device=self.dev, mesh=mesh))
            zero = Zero1(leaf_layouts(cfg, mesh), mesh)
            state = init_state(tcfg.opt, model, zero)
            out["loss"] = float(make_train_step(api.train_loss, tcfg, zero)(
                model, state, batch)[2]["loss"])
        torch.cuda.synchronize()
        out["step_s"] = time.perf_counter() - t0

        @torch.no_grad()
        def compare_slices(one, st):
            whole, mine = named_params(one), named_params(model)
            res = {"over": []}
            worst = {"param": 0.0, "m": 0.0, "v": 0.0}
            for n, lay in zero.layouts.items():
                pairs = [("param", mine[n], lay.local(whole[n], mesh.model_rank))]
                pairs += [(k, state[k][n], zero.slice(n, lay.local(st[k][n], mesh.model_rank)))
                          for k in ("m", "v") if n in state[k]]
                for kind, got, want in pairs:
                    d = (got.float() - want.float()).abs()
                    worst[kind] = max(worst[kind], float(d.max()))
                    lim = (param_tol if kind == "param" else
                           TP_TRAIN_EXACT_MOMENT_ATOL + TP_TRAIN_EXACT_TOL * want.float().abs())
                    if bool((d > lim).any()):
                        res["over"].append((kind, n, float(d.max())))
            res.update(max_param_diff=worst["param"], max_m_diff=worst["m"],
                       max_v_diff=worst["v"], leaves=len(zero.layouts))
            return res

        def compare():
            one = set_trainable(api.init(seed=0, device=self.dev))
            st = init_state(tcfg.opt, one)
            loss = float(make_train_step(api.train_loss, tcfg)(one, st, batch)[2]["loss"])
            res = {"one_rank_loss": loss, **compare_slices(one, st)}
            del one, st
            gc.collect()
            torch.cuda.empty_cache()
            return res

        out.update(one_rank_at_a_time(rank, compare))
        rel = abs(out["loss"] - out["one_rank_loss"]) / abs(out["one_rank_loss"])
        out["loss_rel_diff"] = rel
        if not rel <= TP_TRAIN_EXACT_TOL:
            out["failures"].append(f"loss {out['loss']} against one rank's "
                                   f"{out['one_rank_loss']}: {rel:.2e}")
        if out["over"]:
            out["failures"].append(f"leaves beyond the tolerance (kind, leaf, max |diff|): "
                                   f"{out['over'][:6]}")
        differ = [s for s in seen.values() if s["lanes_differ"]]
        out["k3_shapes"] = len(seen)
        out["k3_differ"] = differ
        if differ:
            out["failures"].append(f"K3 quantize differs from its plain version: {differ}")
        del model, state
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def tp_train_restore(self, cfg, ckpt_dir, world_losses, failures, note):
        """The world's checkpoint of whole leaves (after TP_TRAIN_CKPT_AFTER
        steps, by rank 0) restored here on one rank (another seed's init,
        overwritten leaf by leaf), which takes the remaining steps; its
        first loss against the world's at that step within
        TP_TRAIN_LOSS_RTOL."""
        torch = self.torch
        import gc

        from repro_torch.convert import named_tree
        from repro_torch.models import build
        from repro_torch.models.transformer import set_trainable
        from repro_torch.optim.optimizers import OptConfig, init_state, named_params
        from repro_torch.train import checkpoint as ckpt_lib
        from repro_torch.train.loop import TrainConfig, load_train_tree, make_train_step

        api = build(cfg)
        model = set_trainable(api.init(seed=1, device=self.dev))
        tcfg = TrainConfig(opt=OptConfig(name="adamw", lr=TRAIN_LR))
        state = init_state(tcfg.opt, model)
        # the like tree: the shapes, from the meta device (no copy anywhere)
        meta = api.init(seed=1, device="meta")
        meta_state = init_state(tcfg.opt, meta)
        keep = lambda t: t  # noqa: E731
        like = (named_tree(named_params(meta), keep),
                {**{k: named_tree(v, keep) for k, v in meta_state.items() if k != "step"},
                 "step": state["step"]})
        t0 = time.perf_counter()
        tree, manifest = ckpt_lib.restore(ckpt_dir, like)
        del like
        load_train_tree(tree, model, state)
        del tree
        gc.collect()
        restore_s = time.perf_counter() - t0
        step = make_train_step(api.train_loss, tcfg)
        losses = []
        for i in range(manifest["step"], TP_TRAIN_STEPS):
            batch = self.family_batch(api, cfg, TRAIN_BATCH, TRAIN_SEQ, i)
            losses.append(float(step(model, state, batch)[2]["loss"]))
        rel = abs(losses[0] - world_losses[manifest["step"]]) / abs(world_losses[manifest["step"]])
        if not rel <= TP_TRAIN_LOSS_RTOL:
            failures.append(f"restore: step-{manifest['step']} loss {losses[0]} on one rank "
                            f"against the world's {world_losses[manifest['step']]}: {rel:.2e}")
        if int(state["step"]) != TP_TRAIN_STEPS:
            failures.append(f"restore: the optimizer's step {int(state['step'])}")
        log(f"tp_train restore (2 x 2 -> 1 x 1): the step-{manifest['step']} checkpoint read "
            f"and placed in {restore_s:.1f} s; losses of steps {manifest['step']}-"
            f"{TP_TRAIN_STEPS - 1} on one rank {[round(x, 4) for x in losses]} against the "
            f"world's {[round(x, 4) for x in world_losses[manifest['step']:]]} "
            f"({rel:.2e} at step {manifest['step']}) {note}")
        del model, state, step, meta, meta_state
        gc.collect()
        torch.cuda.empty_cache()
        return {"step": manifest["step"], "losses": losses, "restore_s": restore_s,
                "rel_diff": rel}

    # -- phase 17 ------------------------------------------------------------

    def phase_tp_ssm(self):
        """The state-space and hybrid families over a (data x model) mesh of
        ranks, one world spawned from here (``tp_ssm_rank``), its four
        ranks sharing this card over gloo: each model served at full width
        and depth (``Smoke.tp_ssm_serve``; zamba2 also at batch 1 with its
        shared K/V positions over ``data``) and trained cut in depth
        (``Smoke.tp_ssm_train``), every cell also dry-run on the rank's
        virtual mesh.  One rank's tokens and step-0 losses are taken here
        first."""
        torch = self.torch
        import gc

        from repro_torch.configs import ShapeSpec, get_config
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import choose_backend, spawn
        from repro_torch.models import build

        self.yi_model = None
        gc.collect()
        torch.cuda.empty_cache()
        card = self.results["device"]["nvidia_smi"]
        data, tp = TP_MESH
        backend = choose_backend(data * tp, "cuda")
        note = (f"[{card}; the ranks share this one card over gloo: not multi-card figures]"
                if backend == "gloo" else f"[{torch.cuda.device_count()} x {card}, nccl]")
        failures, res = [], {"card": card, "mesh": {"data": data, "model": tp}}
        t0 = time.perf_counter()
        rows, seq = TP_SSM_PROMPT
        vocab = min(get_config(a).vocab for a in TP_SSM_ARCHS)
        prompt = torch.randint(0, vocab, (rows, seq), generator=self.gen(77), device=self.dev)
        dec = torch.randint(0, vocab, (rows, TP_MESH_F32_DECODE), generator=self.gen(78),
                            device=self.dev)
        jobs, want = {}, {}
        for arch in TP_SSM_ARCHS:
            cfg = tp_cfg(arch, get_config(arch).n_layers)
            want[arch] = self.tp_ssm_one_rank(cfg, prompt)
            want[arch]["f32"] = self.tp_ssm_f32_one_rank(tp_ssm_f32_cfg(arch), prompt, dec)
            jobs[arch] = dict(kind="serve", cfg=cfg, prompt=prompt.cpu(), dec=dec.cpu())
        for arch in TP_SSM_ARCHS:
            cfg = dataclasses.replace(get_config(arch), n_layers=min(
                self.args.layers, TP_SSM_TRAIN_LAYERS[arch]))
            shape = ShapeSpec("tp_ssm_train", TRAIN_SEQ, TRAIN_BATCH, "train")
            step, (model, opt, batch) = dryrun.build_cell(cfg, shape, device=self.dev)
            with torch.no_grad():
                loss0 = float(build(cfg).train_loss(model, batch))
            del step, model, opt, batch
            gc.collect()
            torch.cuda.empty_cache()
            want[f"{arch}/train"] = loss0
            jobs[f"{arch}/train"] = dict(kind="train", cfg=cfg, shape=shape)
        res["one_rank_s"] = time.perf_counter() - t0
        log(f"tp_ssm: a world of {data * tp} ranks, (data {data} x model {tp}) over {backend}; "
            f"one rank's runs here in {res['one_rank_s']:.1f} s")
        t0 = time.perf_counter()
        ranks = spawn(tp_ssm_rank, data * tp, "cuda", self.args, jobs, timeout=TP_MESH_TIMEOUT_S)
        res["world_s"] = time.perf_counter() - t0
        r0 = ranks[0]
        res["backend"], res["world"] = r0["backend"], r0["world"]
        log(f"tp_ssm: backend {r0['backend']}, world {r0['world']}, ranks at (data, model) "
            f"{[(r['data_rank'], r['model_rank']) for r in ranks]}; the world in "
            f"{res['world_s']:.1f} s with the spawn {note}")
        if r0["backend"] != backend or r0["world"] != data * tp:
            failures.append(f"world {r0['world']} over {r0['backend']}, not {data * tp} over "
                            f"{backend}")
        for r in ranks:
            for name in jobs:
                failures.extend(f"{name} rank {r['rank']}: {f}" for f in r[name]["failures"])
        for arch in TP_SSM_ARCHS:
            res[arch] = self.tp_ssm_serve_gates(arch, ranks, want[arch], failures, note)
            res[f"{arch}/train"] = self.tp_ssm_train_gates(
                arch, ranks, want[f"{arch}/train"], failures, note)
        k1 = sum(sum(r0[a]["k1"]) for a in TP_SSM_ARCHS)
        k3 = sum(sum(r0[f"{a}/train"]["k3"]) for a in TP_SSM_ARCHS)
        self.path_launches["plam_matmul"] = self.path_launches.get("plam_matmul", 0) + k1
        self.path_launches["posit_codec"] = self.path_launches.get("posit_codec", 0) + k3
        self.results["tp_ssm"] = res
        if failures:
            raise AssertionError("; ".join(failures[:8]))

    def tp_ssm_model(self, cfg, mesh):
        """``cfg``'s seeded init on this card (this rank's shard under
        ``mesh``), encoded to int16 in place."""
        from repro_torch.core.prequant import quantize_params
        from repro_torch.models import build

        model = build(cfg).init(seed=0, device=self.dev, mesh=mesh)
        quantize_params(cfg, model)
        return model

    def tp_ssm_generate(self, cfg, model, prompt, mesh, base=0, seq_parallel=False):
        """``prompt`` served on ``model`` through the registry's ``prefill``
        and TP_MESH_DECODE greedy ``decode_step``s (with ``seq_parallel``, one
        row whose shared K/V the data ranks hold by positions): each
        position's token, top logit and top-2 margin, and each forward's
        launches; under a mesh also each forward's collectives
        (``Mesh.traffic``) and peak bytes above ``base``."""
        torch = self.torch
        from repro_torch.models import build
        from repro_torch.models.hybrid import seq_shard_caches
        from repro_torch.parallel.sharding import use_mesh

        api = build(cfg)
        out = {k: [] for k in TOP2 + ("launches", "traffic", "peak")}
        with torch.no_grad(), use_mesh(mesh):
            tok, caches = self.served_forward(out, mesh, base,
                                              lambda: api.prefill(model, {"tokens": prompt}))
            if seq_parallel:
                caches = seq_shard_caches(caches, mesh)
            for i in range(TP_MESH_DECODE):
                batch = {"token": tok, "caches": caches, "cache_len": prompt.shape[1] + i}
                if seq_parallel:
                    batch["seq_parallel"] = True
                tok, caches = self.served_forward(out, mesh, base,
                                                  lambda b=batch: api.decode_step(model, b))
        del caches
        for k in TOP2:
            out[k] = torch.stack(out[k], dim=1)
        return out

    def counted(self, mesh, fn):
        """``fn()`` alone on the card, after the peak memory, the launch
        counts and ``mesh``'s traffic are reset: its result, its launches
        and its collectives (``Mesh.traffic``; None without a mesh)."""
        torch = self.torch
        from repro_torch.kernels import _lib

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        if mesh is not None:
            mesh.traffic.clear()
        got = fn()
        torch.cuda.synchronize()
        return got, {k: v for k, v in _lib.launches.items() if v}, (
            None if mesh is None else dict(mesh.traffic))

    def served_forward(self, out, mesh, base, fn):
        """One serving forward ``fn() -> (logits, caches)``, ``counted``: its
        peak bytes above ``base``, launches and collectives appended to
        ``out``'s lists, as each row's greedy token, top logit and top-2
        margin at the last position are.  The tokens as the next [rows, 1]
        input, and the caches."""
        torch = self.torch
        (logits, caches), launches, traffic = self.counted(mesh, fn)
        out["peak"].append(torch.cuda.max_memory_allocated() - base)
        out["launches"].append(launches)
        out["traffic"].append(traffic)
        top = logits[:, -1].float().topk(2, dim=-1)
        out["tokens"].append(top.indices[:, 0])
        out["top"].append(top.values[:, 0])
        out["margins"].append(top.values[:, 0] - top.values[:, 1])
        return top.indices[:, :1].to(torch.int32), caches

    def by_data_rank(self, fn, *batches):
        """``fn`` on each data rank's rows of ``batches`` (of TP_MESH's data
        ranks) in turn, here on one rank: one rank's runs at the batches
        the world's data ranks run (one rank's bf16 decode may depend on the
        batch, PERF.md section 6).  The outputs concatenated on the CPU:
        tensors, or the TOP2 entries of dicts."""
        torch = self.torch
        parts = [fn(*(data_rows(b, d) for b in batches)) for d in range(TP_MESH[0])]
        if isinstance(parts[0], dict):
            return {k: torch.cat([p[k].cpu() for p in parts]) for k in TOP2}
        return torch.cat([p.cpu() for p in parts])

    def tp_ssm_one_rank(self, cfg, prompt):
        """One rank's tokens, top logits and margins for phase tp_ssm's
        gates, at the batches the world serves them: each data rank's rows
        (``prompt`` split over TP_MESH's data axis), and for the hybrid
        row 0 alone (the batch-1 run).  (One rank's decode step depends on
        the batch: the recurrence's f32 ``einsum`` (a batched GEMV) and the
        gated norm's f32 mean change their sum order with the rows, and 48
        bf16 layers carry that to the tokens; the prefill does not,
        ``repro_torch/launch/batch_noise.py``, PERF.md section 6.)"""
        torch = self.torch
        model = self.tp_ssm_model(cfg, None)
        out = self.by_data_rank(lambda rows: self.tp_ssm_generate(cfg, model, rows, None), prompt)
        if cfg.family == "hybrid":
            one = self.tp_ssm_generate(cfg, model, prompt[:1], None)
            out["batch1"] = {k: one[k].cpu() for k in TOP2}
        del model
        torch.cuda.empty_cache()
        return out

    def tp_ssm_f32(self, cfg, model, prompt, dec, mesh, seq_parallel=False):
        """Phase tp_ssm (e): the f32 logits [rows, 1 + decode steps, V] of
        ``prompt``'s prefill and the teacher-forced decode of ``dec`` over
        f32 caches (the modules' own prefill and decode_step, as
        tests/test_torch_tp_ssm.py runs them), TF32 off; with
        ``seq_parallel`` one row whose shared K/V the data ranks hold by
        positions."""
        torch = self.torch
        from repro_torch.models import hybrid, mamba_lm
        from repro_torch.parallel.sharding import use_mesh

        mod = hybrid if cfg.family == "hybrid" else mamba_lm
        s = prompt.shape[1]
        with no_tf32(torch), torch.no_grad(), use_mesh(mesh):
            caches = mod.cache_init(cfg, prompt.shape[0], s if cfg.family == "hybrid" else 0,
                                    torch.float32, self.dev)
            logits, caches = mod.prefill(cfg, model, prompt, caches)
            if seq_parallel:
                caches = hybrid.seq_shard_caches(caches, mesh)
            out = [logits]
            for i in range(dec.shape[1]):
                kw = {"seq_parallel": True} if seq_parallel else {}
                logits, caches = mod.decode_step(cfg, model, dec[:, i:i + 1], caches, s + i, **kw)
                out.append(logits)
        return torch.cat(out, dim=1).float()

    def tp_ssm_f32_one_rank(self, cfg, prompt, dec):
        """One rank's f32 logits for phase tp_ssm (e), at the batches the
        world runs them (each data rank's rows; the hybrid's row 0)."""
        torch = self.torch
        from repro_torch.models import build

        model = build(cfg).init(seed=0, device=self.dev)
        out = {"logits": self.by_data_rank(
            lambda p, d: self.tp_ssm_f32(cfg, model, p, d, None), prompt, dec)}
        if cfg.family == "hybrid":
            out["seq"] = self.tp_ssm_f32(cfg, model, prompt[:1], dec[:1], None).cpu()
        del model
        torch.cuda.empty_cache()
        return out

    def tp_ssm_serve(self, job, mesh):
        """One rank's serving of ``job["cfg"]``: its rows of the prompt, and
        for the hybrid row 0 at batch 1 with the shared K/V positions over
        ``data`` (phase tp_ssm (a), (b)); K1 launches a forward, no plain K1
        or codec call, rank 0's K1 bit for bit; each cell dry-run on this
        rank's virtual mesh (d); (a) and (b) in f32 (e)."""
        torch = self.torch
        import gc

        from repro_torch.configs import ShapeSpec
        from repro_torch.models import build

        cfg = job["cfg"]
        prompt = job["prompt"].to(self.dev)
        mine = data_rows(prompt, mesh.data_rank, mesh.data_size)
        want_k1 = launch_counts(cfg)["k1"]
        out = {"failures": [], "k1_want": want_k1}
        fails = out["failures"]
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            plain = stack.enter_context(self.counting_plain())
            k1_seen = (stack.enter_context(self.recording_k1(clone_b=False)) if mesh.rank == 0
                       else {})
            base = torch.cuda.memory_allocated()
            model = self.tp_ssm_model(cfg, mesh)
            run = self.tp_ssm_generate(cfg, model, mine, mesh, base)
            cells = {"prefill": (ShapeSpec("tp_ssm_prefill", prompt.shape[1], prompt.shape[0],
                                           "prefill"), run, 0),
                     "decode": (ShapeSpec("tp_ssm_decode", prompt.shape[1], prompt.shape[0],
                                          "decode"), run, 1)}
            if cfg.family == "hybrid":
                seq = self.tp_ssm_generate(cfg, model, prompt[:1], mesh, base, seq_parallel=True)
                out["seq"] = {k: seq[k].cpu() for k in TOP2}
                out["seq_k1"] = [f.get("plam_matmul", 0) for f in seq["launches"]]
                cells["seq_decode"] = (ShapeSpec("tp_ssm_seq_decode", prompt.shape[1], 1,
                                                 "decode"), seq, 1)
            del model
        out["serve_s"] = time.perf_counter() - t0
        # (e) the same forms in f32 (teacher-forced), after the bf16 model is gone
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg32 = tp_ssm_f32_cfg(cfg.name)
        dec = job["dec"].to(self.dev)
        model = build(cfg32).init(seed=0, device=self.dev, mesh=mesh)
        got = self.tp_ssm_f32(cfg32, model, mine, data_rows(dec, mesh.data_rank, mesh.data_size),
                              mesh)
        out["f32"] = torch.cat(mesh.all_gather(got.contiguous(), "data")).cpu()
        if cfg.family == "hybrid":
            out["f32_seq"] = self.tp_ssm_f32(cfg32, model, prompt[:1], dec[:1], mesh,
                                             seq_parallel=True).cpu()
        del model, got
        out["f32_s"] = time.perf_counter() - t0
        for k in TOP2:
            out[k] = torch.cat(mesh.all_gather(run[k].contiguous(), "data")).cpu()
        out["k1"] = [f.get("plam_matmul", 0) for f in run["launches"]]
        out["launches"] = run["launches"]
        out["plain_calls"] = dict(plain)
        if any(k != want_k1 for k in out["k1"] + out.get("seq_k1", [])):
            fails.append(f"K1 launches a forward {out['k1']} {out.get('seq_k1', '')}, "
                         f"not {want_k1}")
        if any(f.keys() != {"plam_matmul"} for f in run["launches"]):
            fails.append(f"launches other than K1 in a forward: {run['launches'][:2]}")
        if any(plain.values()):
            fails.append(f"plain K1 or codec calls on the card: {dict(plain)}")
        if mesh.rank == 0:
            out["k1_shapes"] = sorted({(k[0][-1], k[2][-1]) for k in k1_seen})
            out["k1_check"] = self.check_recorded_k1(f"rank 0 {cfg.name} K1", k1_seen, fails)
        # (d) each cell on this rank's virtual mesh, on meta
        out["cells"] = {}
        for name, (shape, got, i) in cells.items():
            out["cells"][name] = self.tp_ssm_dry(cfg, shape, True, mesh, got["launches"][i],
                                                 got["traffic"][i], got["peak"][i], fails)
        return out

    def tp_ssm_train(self, job, mesh):
        """One rank's TP_MESH_TRAIN_STEPS AdamW steps of ``job["cfg"]`` under
        its config's numerics, built by the dry run's ``build_cell`` on the
        card with this rank's mesh (its shard, ZeRO-1 state, the global
        batch that the step cuts): each step's loss, launches and
        collectives; K3 quantizes a step by ``family_quantize_count``, bit
        for bit at rank 0's (shape, dtype), no plain codec call; m + v bytes
        against the per-device ZeRO-1 count; the collectives a step by
        ``tp_ssm_collectives`` (or ``job["count"]``'s, for phase tp_encdec's
        families); the last step dry-run on the virtual mesh (its peak
        within ``job["mem_tol"]``, DRYRUN_MEM_TOL by default)."""
        torch = self.torch
        import gc

        from repro_torch.kernels import _lib
        from repro_torch.launch import dryrun
        from repro_torch.optim.optimizers import Zero1
        from repro_torch.parallel.sharding import leaf_layouts

        cfg, shape = job["cfg"], job["shape"]
        rank = mesh.rank
        base = torch.cuda.memory_allocated()
        step, (model, opt, batch) = dryrun.build_cell(cfg, shape, device=self.dev, mesh=mesh)
        zero = Zero1(leaf_layouts(cfg, mesh), mesh)
        _, want_k3 = self.family_quantize_count(cfg, shape.seq_len)
        out = {"failures": [], "losses": [], "k3": [], "step_s": [], "k3_want": want_k3,
               "state_bytes": sum(t.numel() * t.element_size() for k in ("m", "v")
                                  for t in opt[k].values()),
               "state_bytes_want": dryrun.state_bytes_rules(cfg, mesh),
               "collectives_want": job.get("count", tp_ssm_collectives)(cfg, zero, model),
               "layers": (f"{cfg.enc_layers} + {cfg.dec_layers}" if cfg.family == "encdec"
                          else cfg.n_layers)}
        fails = out["failures"]
        if out["state_bytes"] != out["state_bytes_want"]:
            fails.append(f"m + v {out['state_bytes']} bytes, ZeRO-1's count "
                         f"{out['state_bytes_want']}")
        with contextlib.ExitStack() as stack:
            seen = stack.enter_context(self.recording_k3()) if rank == 0 else {}
            plain = stack.enter_context(self.counting_plain())
            for i in range(TP_MESH_TRAIN_STEPS):
                mesh.traffic.clear()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _lib.reset_launches()
                t0 = time.perf_counter()
                loss = float(step(model, opt, batch)[2]["loss"])
                torch.cuda.synchronize()
                out["step_s"].append(time.perf_counter() - t0)
                out["losses"].append(loss)
                out["k3"].append(_lib.launches["posit_codec"])
                out["collectives"] = dict(mesh.collectives)
                launches = {k: v for k, v in _lib.launches.items() if v}
                traffic, peak = dict(mesh.traffic), torch.cuda.max_memory_allocated() - base
                log(f"  {cfg.name} step {i}: loss {loss:.4f}, {out['step_s'][-1]:.3f} s, "
                    f"launches {launches}, collectives {out['collectives']}")
                if out["collectives"] != out["collectives_want"]:
                    fails.append(f"collectives step {i} {out['collectives']}, hand count "
                                 f"{out['collectives_want']}")
        out["plain_calls"] = dict(plain)
        out["k3_seen"] = list(seen.values())
        if any(n != want_k3 for n in out["k3"]):
            fails.append(f"K3 launches a step {out['k3']}, expected {want_k3}")
        if any(plain.values()):
            fails.append(f"plain calls on the card {dict(plain)}")
        differ = [s for s in seen.values() if s["lanes_differ"]]
        if differ or (rank == 0 and not seen):
            fails.append(f"K3 quantize differs from its plain version: {differ}")
        del step, model, opt, batch, zero
        gc.collect()
        torch.cuda.empty_cache()
        # (d) the last step (after the first's K3 table build) on the virtual mesh
        out["cell"] = self.tp_ssm_dry(cfg, shape, False, mesh, launches, traffic, peak, fails,
                                      tol=job.get("mem_tol", DRYRUN_MEM_TOL))
        return out

    def tp_ssm_dry(self, cfg, shape, prequantize, mesh, launches, traffic, peak, fails,
                   tol=DRYRUN_MEM_TOL, inputs=None):
        """Phase tp_ssm (d): ``shape``'s cell dry-run on meta as rank
        ``mesh.rank`` of a virtual mesh of ``mesh``'s shape (a training step
        after a warm-up, as the measured step followed the first, which
        builds K3's table), against this rank's measured launches,
        collectives by axis and kind, and peak bytes (within ``tol``).
        ``inputs``: the served forward's own inputs as meta tensors, in
        place of the shape's (``dryrun.build_cell``)."""
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import VirtualMesh

        vm = VirtualMesh(mesh.rank, data=mesh.data_size, model=mesh.model_size)
        t0 = time.perf_counter()
        rec, _ = dryrun.analyze_cell(cfg, shape, prequantize=prequantize, mesh=vm,
                                     warmup=shape.kind == "train", inputs=inputs)
        predicted = rec["memory"]["peak_bytes"]
        row = {"launches": launches, "dry_launches": rec["launches"], "traffic": traffic,
               "dry_traffic": dict(vm.traffic), "measured_peak_bytes": peak,
               "predicted_peak_bytes": predicted, "peak_err": (predicted - peak) / peak,
               "dry_run_s": time.perf_counter() - t0}
        what = f"{cfg.name} {shape.name}"
        if rec["launches"] != launches:
            fails.append(f"{what}: the dry run's launches {rec['launches']}, measured {launches}")
        if row["dry_traffic"] != traffic:
            fails.append(f"{what}: the dry run's collectives {row['dry_traffic']}, measured "
                         f"{traffic}")
        if abs(row["peak_err"]) > tol:
            fails.append(f"{what}: predicted peak {predicted / 2**30:.3f} GiB is "
                         f"{row['peak_err']:+.3f} of the measured {peak / 2**30:.3f}")
        return row

    @staticmethod
    def tp_ssm_departure(got, want):
        """Where ``got``'s tokens first part from ``want``'s (one rank's) in
        each row: [(row, position, one rank's top-2 margin there)], [] where
        none does; and the largest |difference| of the top logit at the
        positions before that (both runs in the same context)."""
        parts, noise = [], 0.0
        for r in range(want["tokens"].shape[0]):
            differ = (got["tokens"][r] != want["tokens"][r]).nonzero()
            j = int(differ[0, 0]) if len(differ) else want["tokens"].shape[1]
            if j < want["tokens"].shape[1]:
                parts.append((r, j, float(want["margins"][r, j])))
            if j:
                noise = max(noise, float((got["top"][r, :j] - want["top"][r, :j]).abs().max()))
        return parts, noise

    def tp_mesh_gates(self, arch, ranks, want, f32, failures):
        """Phases tp_ssm and tp_encdec, a served model: every rank's gathered
        tokens equal, and equal to one rank's at the same rows or parting
        where one rank's top-2 margin is below TP_MESH_MARGIN; each of
        ``f32``'s (world's, one rank's) logits within TP_MESH_F32_TOL of one
        rank's, relative to its largest |logit|.  The phase's row: each
        rank's record without its tensors, the departures, the top logit's
        gap before them and the f32 errors."""
        r0 = ranks[0][arch]
        row = {"ranks": [{k: v for k, v in r[arch].items()
                          if k not in TOP2 + ("seq", "f32", "f32_seq")} for r in ranks]}
        for r in ranks[1:]:
            if not self.torch.equal(r[arch]["tokens"], r0["tokens"]):
                failures.append(f"{arch}: rank {r['rank']}'s tokens differ from rank 0's")
        parts, noise = self.tp_ssm_departure(r0, want)
        row.update(departures=parts, top_logit_diff=noise)
        if any(m >= TP_MESH_MARGIN for _, _, m in parts):
            failures.append(f"{arch}: tokens part from one rank's at (row, position, margin) "
                            f"{parts}")
        row["f32_rel_err"] = {k: float((g - w).abs().max() / w.abs().max())
                              for k, (g, w) in f32.items()}
        for k, e in row["f32_rel_err"].items():
            if not e <= TP_MESH_F32_TOL:
                failures.append(f"{arch} f32 {k}: {e:.3e} of one rank's largest |logit| from "
                                f"one rank's, over {TP_MESH_F32_TOL}")
        return row

    @staticmethod
    def log_mesh_details(row, r0):
        """The f32 gate's and each dry-run cell's lines of a served model
        (phases tp_ssm and tp_encdec)."""
        log(f"  f32 (parameters, activations, numerics, caches; TF32 off), the prefill and "
            f"{TP_MESH_F32_DECODE} teacher-forced decode steps: logits from one rank's by "
            + ", ".join(f"{k} {e:.3e}" for k, e in row["f32_rel_err"].items())
            + f" of its largest |logit| (tol {TP_MESH_F32_TOL}), in {r0['f32_s']:.1f} s")
        for name, c in r0["cells"].items():
            Smoke.log_dry(f"dry run {name} (rank 0)", c)

    @staticmethod
    def log_dry(what, c):
        """A dry-run cell's launches, collectives and peak beside the measured ones."""
        log(f"  {what}: launches {c['dry_launches']} (measured {c['launches']}); collectives "
            f"{c['dry_traffic']} (measured {c['traffic']}); peak predicted "
            f"{c['predicted_peak_bytes'] / 2**30:.3f} GiB, measured "
            f"{c['measured_peak_bytes'] / 2**30:.3f} GiB ({c['peak_err']:+.4f})")

    def tp_ssm_serve_gates(self, arch, ranks, want, failures, note):
        """Phase tp_ssm (a), (b), (e): ``tp_mesh_gates`` over each data
        rank's rows and, for the hybrid, the batch-1 row whose shared K/V
        the data ranks hold by positions."""
        r0 = ranks[0][arch]
        f32 = {"logits": (r0["f32"], want["f32"]["logits"])}
        if "f32_seq" in r0:
            f32["batch 1 over data"] = (r0["f32_seq"], want["f32"]["seq"])
        row = self.tp_mesh_gates(arch, ranks, want, f32, failures)
        seq_log = ""
        if "seq" in r0:
            seq, seq_noise = self.tp_ssm_departure(r0["seq"], want["batch1"])
            row.update(seq_departures=seq, seq_top_logit_diff=seq_noise)
            seq_log = (f"; batch 1 over data: {seq or 'equal'}, top logit within "
                       f"{seq_noise:.4f}")
            if any(m >= TP_MESH_MARGIN for _, _, m in seq):
                failures.append(f"{arch} batch 1 over data: tokens part from one rank's at "
                                f"{seq}")
        log(f"tp_ssm {arch} (full width and depth, prequantized plam_sim): K1 a forward "
            f"{sorted(set(r0['k1'] + r0.get('seq_k1', [])))} (hand count {r0['k1_want']}), "
            f"rank 0's K1 at (K, N) {r0.get('k1_shapes')}; tokens against one rank's at the "
            f"same batches: {row['departures'] or 'equal'} (row, position, one rank's margin), "
            f"the top logit within {row['top_logit_diff']:.4f} before that{seq_log}; served in "
            f"{r0['serve_s']:.1f} s {note}")
        self.log_mesh_details(row, r0)
        return row

    def tp_ssm_train_gates(self, arch, ranks, loss0, failures, note, phase="tp_ssm"):
        """Phase tp_ssm (c): every rank's losses equal, finite, step 0 within
        TP_TRAIN_LOSS_RTOL of one rank's."""
        import math

        key = f"{arch}/train"
        r0 = ranks[0][key]
        for r in ranks[1:]:
            if r[key]["losses"] != r0["losses"]:
                failures.append(f"{key} rank {r['rank']}: losses {r[key]['losses']} differ "
                                f"from rank 0's {r0['losses']}")
        rel = abs(r0["losses"][0] - loss0) / abs(loss0)
        if not (rel <= TP_TRAIN_LOSS_RTOL and all(math.isfinite(x) for x in r0["losses"])):
            failures.append(f"{key}: losses {r0['losses']}, step 0 against one rank's {loss0}: "
                            f"{rel:.2e}")
        log(f"{phase} {key} ({r0['layers']} layers, posit_quant:16:1, AdamW lr "
            f"1e-4, ZeRO-1): losses {[round(x, 4) for x in r0['losses']]} (step 0 {rel:.2e} "
            f"from one rank's {loss0:.4f}); step seconds {[round(x, 3) for x in r0['step_s']]}; "
            f"K3 a step {r0['k3']} (hand count {r0['k3_want']}); m + v a rank "
            f"{[r[key]['state_bytes'] for r in ranks]} (ZeRO-1's {r0['state_bytes_want']}); "
            f"collectives a step {r0['collectives']} (hand count {r0['collectives_want']}) {note}")
        self.log_dry("dry run of the step (rank 0)", r0["cell"])
        return {"ranks": [r[key] for r in ranks], "step0_rel_diff": rel, "one_rank_loss0": loss0}

    # -- phase tp_encdec ------------------------------------------------------

    def phase_tp_encdec(self):
        """The encoder-decoder and vlm families over a (data x model) mesh of
        ranks, one world spawned from here (``tp_encdec_rank``), its four
        ranks sharing this card over gloo (a card a rank over nccl): each
        model served through the registry's static entry points
        (``Smoke.tp_encdec_serve``) and seamless trained (phase tp_ssm's
        ``Smoke.tp_ssm_train``), every cell also dry-run on the rank's
        virtual mesh; qwen2-vl trained with a card a rank, else its step
        counted on the virtual mesh here.  One rank's tokens, f32 logits and
        step-0 losses are taken here first."""
        torch = self.torch
        import gc

        from repro_torch.configs import ShapeSpec, get_config
        from repro_torch.launch.mesh import choose_backend, spawn
        from repro_torch.models.registry import vlm_patches

        self.yi_model = None
        gc.collect()
        torch.cuda.empty_cache()
        card = self.results["device"]["nvidia_smi"]
        data, tp = TP_MESH
        backend = choose_backend(data * tp, "cuda")
        note = (f"[{card}; the ranks share this one card over gloo: not multi-card figures]"
                if backend == "gloo" else f"[{torch.cuda.device_count()} x {card}, nccl]")
        failures, res = [], {"card": card, "mesh": {"data": data, "model": tp}}
        t0 = time.perf_counter()
        jobs, want = {}, {}
        for arch in TP_ENCDEC_ARCHS:
            cfg = tp_encdec_cfg(arch)
            tokens, extra = self.archs_inputs(cfg, 91)
            batch = {"tokens": tokens.to(self.dev), **extra}
            dec = torch.randint(0, cfg.vocab, (tokens.shape[0], TP_MESH_F32_DECODE),
                                generator=self.gen(92), device=self.dev, dtype=torch.int32)
            want[arch] = self.tp_encdec_one_rank(cfg, batch)
            want[arch]["f32"] = self.tp_encdec_f32_one_rank(tp_encdec_f32_cfg(arch), batch, dec)
            jobs[arch] = dict(kind="serve", cfg=cfg, dec=dec.cpu(),
                              batch={k: v.cpu() for k, v in batch.items()})
        train = {"seamless-m4t-medium": (
            tp_encdec_train_cfg(min(self.args.layers, TP_ENCDEC_TRAIN_LAYERS)),
            ShapeSpec("tp_encdec_train", TRAIN_SEQ, TRAIN_BATCH, "train"))}
        vlm = dataclasses.replace(get_config("qwen2-vl-72b"),
                                  n_layers=min(self.args.layers, TP_ENCDEC_VLM_TRAIN_LAYERS))
        vlm_shape = ShapeSpec("tp_encdec_vlm_train", vlm_patches(vlm) + TRAIN_SEQ,
                              FAMILY_VLM_ROWS, "train")
        if backend == "nccl":  # a card a rank: room for qwen2-vl's step
            train["qwen2-vl-72b"] = (vlm, vlm_shape)
        else:
            res["qwen2-vl-72b/train_dry"] = self.tp_encdec_vlm_dry(vlm, vlm_shape, failures, note)
        for arch, (cfg, shape) in train.items():
            want[f"{arch}/train"] = self.tp_encdec_loss0(cfg, shape)
            jobs[f"{arch}/train"] = dict(kind="train", cfg=cfg, shape=shape,
                                         count=tp_encdec_collectives,
                                         mem_tol=TP_ENCDEC_STEP_MEM_TOL)
        res["one_rank_s"] = time.perf_counter() - t0
        log(f"tp_encdec: a world of {data * tp} ranks, (data {data} x model {tp}) over "
            f"{backend}; one rank's runs here in {res['one_rank_s']:.1f} s")
        t0 = time.perf_counter()
        ranks = spawn(tp_encdec_rank, data * tp, "cuda", self.args, jobs,
                      timeout=TP_MESH_TIMEOUT_S)
        res["world_s"] = time.perf_counter() - t0
        r0 = ranks[0]
        res["backend"], res["world"] = r0["backend"], r0["world"]
        log(f"tp_encdec: backend {r0['backend']}, world {r0['world']}, ranks at (data, model) "
            f"{[(r['data_rank'], r['model_rank']) for r in ranks]}; the world in "
            f"{res['world_s']:.1f} s with the spawn {note}")
        if r0["backend"] != backend or r0["world"] != data * tp:
            failures.append(f"world {r0['world']} over {r0['backend']}, not {data * tp} over "
                            f"{backend}")
        for r in ranks:
            for name in jobs:
                failures.extend(f"{name} rank {r['rank']}: {f}" for f in r[name]["failures"])
        for arch in TP_ENCDEC_ARCHS:
            res[arch] = self.tp_encdec_serve_gates(arch, ranks, want[arch], failures, note)
        for arch in train:
            res[f"{arch}/train"] = self.tp_ssm_train_gates(
                arch, ranks, want[f"{arch}/train"], failures, note, phase="tp_encdec")
        k1 = sum(sum(r0[a]["k1"]) + r0[a]["encode_k1"] for a in TP_ENCDEC_ARCHS)
        k3 = sum(sum(r0[f"{a}/train"]["k3"]) for a in train)
        self.path_launches["plam_matmul"] = self.path_launches.get("plam_matmul", 0) + k1
        self.path_launches["posit_codec"] = self.path_launches.get("posit_codec", 0) + k3
        self.results["tp_encdec"] = res
        if failures:
            raise AssertionError("; ".join(failures[:8]))

    def tp_encdec_generate(self, cfg, model, batch, mesh, base=0, steps=TP_MESH_DECODE):
        """``batch`` (tokens and the frames or patch embeddings) served on
        ``model`` through the registry's static ``prefill`` and ``steps``
        greedy ``decode_step``s over caches grown by ``steps`` positions, as
        the static engine grows them (the encdec's over its encoder output,
        encoded once more after the prefill, as the engine does): each
        position's token, top logit and top-2 margin, and each forward's
        launches, collectives (``Mesh.traffic``), peak bytes above ``base``
        and inputs (as meta tensors, for the dry run); the encode's
        launches and collectives under ``"encode"``."""
        torch = self.torch
        from repro_torch.models import build, encdec
        from repro_torch.parallel.sharding import use_mesh

        api = build(cfg)
        out = {k: [] for k in TOP2 + ("launches", "traffic", "peak", "inputs")}
        out["encode"] = {"launches": {}, "traffic": {}}

        def forward(inputs, fn):
            out["inputs"].append(meta_like(torch, inputs))
            return self.served_forward(out, mesh, base, fn)

        with torch.no_grad(), use_mesh(mesh):
            tok, caches = forward(batch, lambda: api.prefill(model, batch))
            pad = (0, 0, 0, 0, 0, steps)  # the sequence axis of [L, B, S, kv, hd]
            caches = tuple(torch.nn.functional.pad(c, pad) for c in caches)
            at = caches[0].shape[2] - steps
            extra = {}
            if cfg.family == "encdec":
                extra["enc_out"], launches, traffic = self.counted(
                    mesh, lambda: encdec.encode(cfg, model, batch["frames"]))
                out["encode"] = {"launches": launches, "traffic": traffic}
            for i in range(steps):
                step = {"token": tok, "kv_caches": caches, "cache_len": at + i, **extra}
                tok, caches = forward(step, lambda b=step: api.decode_step(model, b))
        del caches, extra
        for k in TOP2:
            out[k] = torch.stack(out[k], dim=1)
        return out

    def tp_encdec_one_rank(self, cfg, batch):
        """One rank's tokens, top logits and margins for phase tp_encdec's
        gates, at the batches the world serves them (each data rank's
        rows)."""
        torch = self.torch
        model = self.tp_ssm_model(cfg, None)
        out = self.by_data_rank(lambda rows: self.tp_encdec_generate(cfg, model, rows, None),
                                batch)
        del model
        torch.cuda.empty_cache()
        return out

    def tp_encdec_f32(self, cfg, model, batch, dec, mesh):
        """Phase tp_encdec (a): the f32 logits [rows, 1 + decode steps, V] of
        ``batch``'s prefill (tokens and frames or patch embeddings) and the
        teacher-forced decode of ``dec`` over f32 caches with room for it
        (the modules' own prefill and decode_step, as
        tests/test_torch_tp_encdec.py runs them), TF32 off."""
        torch = self.torch
        from repro_torch.models import encdec, transformer
        from repro_torch.parallel.sharding import use_mesh

        f32 = torch.float32
        batch = {k: v.to(self.dev, f32) if v.is_floating_point() else v.to(self.dev)
                 for k, v in batch.items()}
        tokens, n = batch["tokens"], dec.shape[1]
        b, s = tokens.shape
        with no_tf32(torch), torch.no_grad(), use_mesh(mesh):
            if cfg.family == "encdec":
                kv = model.dec_layers[0].attn.wk.shape[-1] // cfg.hd
                caches = encdec.kv_cache_init(cfg, b, s + n, f32, self.dev, kv)
                logits, caches = encdec.prefill(cfg, model, batch["frames"], tokens, caches)
                enc_out = encdec.encode(cfg, model, batch["frames"])

                def step(tok, caches, at):
                    return encdec.decode_step(cfg, model, tok, enc_out, caches, at)
            else:
                s += batch["embeds_prefix"].shape[1]
                caches = transformer.kv_cache_init(cfg, b, s + n, f32, self.dev,
                                                   transformer.local_kv_heads(cfg, model))
                logits, caches = transformer.prefill_prefix(cfg, model, tokens,
                                                            batch["embeds_prefix"], caches)

                def step(tok, caches, at):
                    return transformer.decode_step(cfg, model, tok, caches, at)
            out = [logits]
            for i in range(n):
                logits, caches = step(dec[:, i:i + 1].to(self.dev), caches, s + i)
                out.append(logits)
        return torch.cat(out, dim=1).float()

    def tp_encdec_f32_one_rank(self, cfg, batch, dec):
        """One rank's f32 logits for phase tp_encdec (a), at the batches the
        world runs them (each data rank's rows)."""
        torch = self.torch
        from repro_torch.models import build

        model = build(cfg).init(seed=0, device=self.dev)
        got = self.by_data_rank(lambda rows, d: self.tp_encdec_f32(cfg, model, rows, d, None),
                                batch, dec)
        del model
        torch.cuda.empty_cache()
        return got

    def tp_encdec_loss0(self, cfg, shape):
        """One rank's step-0 loss of ``shape``'s training cell (the dry run's
        ``build_cell`` on this card, as the ranks build theirs): a no-grad
        forward of the global batch."""
        torch = self.torch
        import gc

        from repro_torch.launch import dryrun
        from repro_torch.models import build

        step, (model, opt, batch) = dryrun.build_cell(cfg, shape, device=self.dev)
        del step, opt
        with torch.no_grad():
            loss0 = float(build(cfg).train_loss(model, batch))
        del model, batch
        gc.collect()
        torch.cuda.empty_cache()
        return loss0

    def tp_encdec_vlm_dry(self, cfg, shape, failures, note):
        """qwen2-vl-72b's sharded training step on one card: rank 0 of the
        virtual (data x model) mesh, traced on meta (after a warm-up), its
        collectives against ``tp_encdec_collectives`` and its K3 quantizes
        against ``family_quantize_count`` (four ranks on one card cannot
        hold the step; a card a rank trains it)."""
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import VirtualMesh
        from repro_torch.models import build
        from repro_torch.optim.optimizers import Zero1
        from repro_torch.parallel.sharding import leaf_layouts, use_mesh

        vm = VirtualMesh(0, data=TP_MESH[0], model=TP_MESH[1])
        t0 = time.perf_counter()
        rec, _ = dryrun.analyze_cell(cfg, shape, mesh=vm, warmup=True)
        got = dict(vm.collectives)
        with use_mesh(vm):
            model = build(cfg).init(device="meta", mesh=vm)
        want = tp_encdec_collectives(cfg, Zero1(leaf_layouts(cfg, vm), vm), model)
        _, k3 = self.family_quantize_count(cfg, shape.seq_len)
        row = {"launches": rec["launches"], "collectives": got, "collectives_want": want,
               "k3_want": k3, "predicted_peak_bytes": rec["memory"]["peak_bytes"],
               "param_bytes": rec["memory"]["param_bytes"],
               "opt_state_bytes": rec["memory"]["opt_state_bytes"],
               "opt_state_bytes_rules": rec["memory"]["opt_state_bytes_rules"],
               "dry_run_s": time.perf_counter() - t0}
        if got != want:
            failures.append(f"qwen2-vl-72b step on the virtual mesh: collectives {got}, hand "
                            f"count {want}")
        if rec["launches"].get("posit_codec") != k3:
            failures.append(f"qwen2-vl-72b step on the virtual mesh: K3 {rec['launches']}, "
                            f"expected {k3}")
        if row["opt_state_bytes"] != row["opt_state_bytes_rules"]:
            failures.append(f"qwen2-vl-72b m + v {row['opt_state_bytes']} bytes, ZeRO-1's "
                            f"count {row['opt_state_bytes_rules']}")
        log(f"tp_encdec qwen2-vl-72b/train ({cfg.n_layers} layers, {shape.global_batch} x "
            f"{shape.seq_len} positions): not run on one card (four ranks cannot hold its "
            f"step); rank 0's step on the virtual (data {vm.data_size} x model "
            f"{vm.model_size}) mesh: launches {rec['launches']} (K3 hand count {k3}), "
            f"collectives {got} (hand count {want}), m + v {row['opt_state_bytes']:.0f} bytes "
            f"(ZeRO-1's {row['opt_state_bytes_rules']:.0f}), predicted peak "
            f"{row['predicted_peak_bytes'] / 2**30:.2f} GiB a rank {note}")
        return row

    def tp_encdec_serve(self, job, mesh):
        """One rank's serving of ``job["cfg"]`` (phase tp_encdec (b)-(e)): its
        rows of the prompt through the registry's static entry points; K1
        launches a forward and an encode, no other launch, no plain K1 or
        codec call; the collectives a forward and an encode against
        ``tp_encdec_forward_collectives``; rank 0's K1 bit for bit (rows
        0-63 and the last 64-row block, in a second, recorded prefill and
        decode step); the prefill and a decode step dry-run on this rank's
        virtual mesh at their own inputs; then (a) in f32."""
        torch = self.torch
        import gc

        from repro_torch.configs import ShapeSpec
        from repro_torch.models import build

        cfg = job["cfg"]
        data = mesh.data_size
        batch = {k: v.to(self.dev) for k, v in job["batch"].items()}
        mine = data_rows(batch, mesh.data_rank, data)
        lc = launch_counts(cfg)
        out = {"failures": [],
               "k1_want": [lc["enc_k1"] + lc["k1"]] + [lc["k1"]] * TP_MESH_DECODE,
               "encode_k1_want": lc["enc_k1"],
               "layers": (f"{cfg.enc_layers} + {cfg.dec_layers}" if cfg.family == "encdec"
                          else cfg.n_layers)}
        fails = out["failures"]
        t0 = time.perf_counter()
        with self.counting_plain() as plain:
            base = torch.cuda.memory_allocated()
            model = self.tp_encdec_init(lambda: self.tp_ssm_model(cfg, mesh))
            run = self.tp_encdec_generate(cfg, model, mine, mesh, base)
            out["serve_s"] = time.perf_counter() - t0
            hand = tp_encdec_forward_collectives(cfg, model.vocab_parallel)
            # every rank runs the recorded prefill and decode step (their
            # collectives), rank 0 keeps its K1 launches
            with contextlib.ExitStack() as stack:
                seen = (stack.enter_context(self.recording_k1_rows(list(model.parameters())))
                        if mesh.rank == 0 else {})
                self.tp_encdec_generate(cfg, model, mine, mesh, base, steps=1)
            del model
        if mesh.rank == 0:  # the plain version on the card, outside counting_plain
            out["k1_check"] = self.check_recorded_rows(f"rank 0 {cfg.name} K1", seen, fails)
        del seen
        out["k1"] = [f.get("plam_matmul", 0) for f in run["launches"]]
        out["encode_k1"] = run["encode"]["launches"].get("plam_matmul", 0)
        out["launches"] = run["launches"]
        out["plain_calls"] = dict(plain)
        out["collectives"] = {"forward": [calls(t) for t in run["traffic"]],
                              "encode": calls(run["encode"]["traffic"])}
        out["collectives_want"] = hand
        if out["k1"] != out["k1_want"] or out["encode_k1"] != out["encode_k1_want"]:
            fails.append(f"K1 launches a forward {out['k1']}, an encode {out['encode_k1']}; "
                         f"expected {out['k1_want']}, {out['encode_k1_want']}")
        if any(f.keys() - {"plam_matmul"} for f in run["launches"] + [run["encode"]["launches"]]):
            fails.append(f"launches other than K1 in a forward: {run['launches'][:2]}")
        if any(plain.values()):
            fails.append(f"plain K1 or codec calls on the card: {dict(plain)}")
        want_calls = [hand["prefill"]] + [hand["decode"]] * TP_MESH_DECODE
        if out["collectives"]["forward"] != want_calls or (
                cfg.family == "encdec" and out["collectives"]["encode"] != hand["encode"]):
            fails.append(f"collectives {out['collectives']}, hand count {hand}")
        # (e) the prefill and a decode step on this rank's virtual mesh, at their inputs
        out["cells"] = {}
        rows = mine["tokens"].shape[0]
        for name, i in (("prefill", 0), ("decode", 1)):
            shape = ShapeSpec(f"tp_encdec_{name}", mine["tokens"].shape[1], rows * data, name)
            out["cells"][name] = self.tp_ssm_dry(
                cfg, shape, True, mesh, run["launches"][i], run["traffic"][i], run["peak"][i],
                fails, tol=TP_ENCDEC_SERVE_MEM_TOL, inputs=run["inputs"][i])
        for k in TOP2:
            out[k] = torch.cat(mesh.all_gather(run[k].contiguous(), "data")).cpu()
        del run
        # (a) the same forms in f32 (teacher-forced), after the bf16 model is gone
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg32 = tp_encdec_f32_cfg(cfg.name)
        model = self.tp_encdec_init(lambda: build(cfg32).init(seed=0, device=self.dev, mesh=mesh))
        dec = data_rows(job["dec"], mesh.data_rank, data)
        got = self.tp_encdec_f32(cfg32, model, mine, dec, mesh)
        out["f32"] = torch.cat(mesh.all_gather(got.contiguous(), "data")).cpu()
        del model, got
        out["f32_s"] = time.perf_counter() - t0
        return out

    def tp_encdec_init(self, init):
        """``init()`` (a rank's shard) on each rank of the world in turn, the
        freed blocks of its draws (one whole f32 tensor at a time) handed
        back before the next rank draws: four ranks' transients at once do
        not fit beside their shards on one card."""
        torch = self.torch

        def one():
            model = init()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            return model

        return one_rank_at_a_time(self.torch.distributed.get_rank(), one)

    def tp_encdec_serve_gates(self, arch, ranks, want, failures, note):
        """Phase tp_encdec (a), (b): ``tp_mesh_gates`` over each data rank's
        rows."""
        r0 = ranks[0][arch]
        row = self.tp_mesh_gates(arch, ranks, want, {"logits": (r0["f32"], want["f32"])},
                                 failures)
        enc = (f", an encode {r0['encode_k1']} (hand count {r0['encode_k1_want']})"
               if r0["encode_k1_want"] else "")
        coll = r0["collectives"]
        enc_coll = f", an encode {coll['encode']}" if r0["encode_k1_want"] else ""
        log(f"tp_encdec {arch} (full width, {r0['layers']} layers, prequantized plam_sim): "
            f"K1 a forward {sorted(set(r0['k1']))} (hand count {sorted(set(r0['k1_want']))}){enc};"
            f" collectives a prefill {coll['forward'][0]}, a decode step {coll['forward'][1]}"
            f"{enc_coll} (hand count {r0['collectives_want']}); tokens against one rank's at the "
            f"same rows: {row['departures'] or 'equal'} (row, position, one rank's margin), the "
            f"top logit within {row['top_logit_diff']:.4f} before that; served in "
            f"{r0['serve_s']:.1f} s {note}")
        self.log_mesh_details(row, r0)
        return row

    def kernels_line(self):
        out = []
        for name, (row, source, replaces) in self.kernels.items():
            out.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": self.path_launches.get(name, 0),
                "max_abs_err": self.kernel_err.get(name),
                "ms": row["ms"], "kernel_ms": row["ms"], "device_ms": row["device_ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": row["shape"],
            })
        return {"kernels": out}


TOP2 = ("tokens", "top", "margins")  # a served run's greedy tokens, top logits, top-2 margins


@contextlib.contextmanager
def no_tf32(torch):
    """TF32 off for matmuls and convolutions inside, then as it was."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def data_rows(x, d, data=TP_MESH[0]):
    """Data rank ``d``'s rows (of ``data`` ranks) of a tensor, or of every
    leaf of a dict of tensors."""
    if isinstance(x, dict):
        return {k: data_rows(v, d, data) for k, v in x.items()}
    n = x.shape[0] // data
    return x[d * n:(d + 1) * n]


def tp_ssm_f32_cfg(arch):
    """``arch`` as its config gives it, with f32 parameters, activations
    and numerics (phase tp_ssm (e))."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), param_dtype="float32", act_dtype="float32")
    return cfg.with_numerics("default=f32")


def tp_cfg(arch, layers):
    """``arch`` at full width, ``layers`` deep, under default=plam_sim:16:1."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    return cfg.with_numerics("default=plam_sim:16:1")


def tp_rank(device, args, job):
    """One rank of phase tp (``launch/mesh.py::spawn``): the seeded init
    drawn and cut for this rank, encoded to int16 in place, then each of
    ``job["runs"]`` served on it through ``Smoke.serve_run`` (launches
    per forward gated; K1's and K2's operands recorded where asked, and
    no plain K1 or codec call allowed); then K1 bit for bit against its
    plain version at each (M, K, N) launched, K2 within K5's gates, K1's
    device times at the sharded shapes and the collectives' share of a
    decode step (rank 0 times, the others wait).  Rank 0 logs."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.prequant import quantize_params
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServeOptions, build_engine

    rank = dist.get_rank()
    with contextlib.ExitStack() as quiet:
        if rank:
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
        smoke = Smoke(args)
        cfg = tp_cfg(job["arch"], job["layers"])
        mesh = make_host_mesh(model=job["tp"])
        torch.cuda.reset_peak_memory_stats()
        model = tf.lm_init(cfg, seed=0, device=device, mesh=mesh)
        quantize_params(cfg, model)
        out = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend(),
               "failures": [], "outputs": {}, "step_p50_s": {}, "runs": {}}
        fails = out["failures"]
        if job.get("backend") and out["backend"] != job["backend"]:
            fails.append(f"backend {out['backend']}, not {job['backend']}")
        counts = (launch_counts(cfg) if not cfg.n_experts else None)
        record_k1 = bool(job.get("k1_shapes") or job.get("check_k1"))
        with contextlib.ExitStack() as stack:
            plain = stack.enter_context(smoke.counting_plain())
            k1_seen = (stack.enter_context(smoke.recording_k1(clone_b=False)) if record_k1
                       else {})
            k2_seen = stack.enter_context(smoke.recording_k2()) if job.get("check_k2") else {}
            events = (stack.enter_context(smoke.recording_serve_events()) if cfg.n_experts
                      else None)
            for name, over in job["runs"].items():
                opts = ServeOptions(tp=job["tp"], **{**job["base"], **over})
                run = smoke.serve_run(f"rank {rank} {name}", cfg, model, opts, job["prompts"])
                gates = (smoke.moe_gates(run, cfg, False) if cfg.n_experts
                         else smoke.forward_gates(run, cfg.n_layers, counts))
                fails.extend(f"{name}: {f}" for f in gates)
                out["outputs"][name] = run["outputs"]
                out["step_p50_s"][name] = run["step_p50_s"]
                out["runs"][name] = run_summary(run)
        # the serving peak: before the checks' plain versions run on the card
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if any(plain.values()):
            fails.append(f"plain K1 or codec calls on the card: {plain}")
        if events is not None and rank == 0:
            out["events"] = events
        probe = build_engine(cfg, ServeOptions(tp=job["tp"], **job["base"]), params=model)
        out["pool_layout"], out["kv_heads"] = probe.pool_layout, probe._k_pool.shape[3]
        if job.get("layout") and probe.pool_layout != job["layout"]:
            fails.append(f"pool layout {probe.pool_layout}, not {job['layout']}")
        del probe
        if job.get("k1_shapes"):
            shapes = {key[2][-2:] for key in k1_seen}
            if shapes != job["k1_shapes"]:
                fails.append(f"K1 (K, N) launched {sorted(shapes)}, not "
                             f"{sorted(job['k1_shapes'])}")
        if job.get("time_k1"):
            out["k1_times"] = tp_k1_times(smoke, k1_seen, rank)
        if record_k1:
            out["k1_check"] = smoke.check_recorded_k1(f"rank {rank} K1", k1_seen, fails)
        if job.get("check_k2"):
            out["k2"] = one_rank_at_a_time(rank, lambda: tp_check_k2(smoke, rank, k2_seen, fails))
            heads = {(r["h"], r["kv"]) for r in out["k2"]}
            want = (cfg.n_heads // job["tp"], out["kv_heads"])
            if heads != {want}:
                fails.append(f"K2 ran on (q, kv) heads {heads}, not {want}")
        if job.get("collectives"):
            out["collectives"] = tp_collective_share(smoke, cfg, model, job)
        del model
    return out


def one_rank_at_a_time(rank, fn):
    """fn() on each rank in turn, the others held at a barrier, so that the
    card times one rank's launches at a time."""
    import torch.distributed as dist

    out = None
    for turn in range(dist.get_world_size()):
        dist.barrier()
        if turn == rank:
            out = fn()
    dist.barrier()
    return out


def tp_check_k2(smoke, rank, seen, fails):
    """``Smoke.check_k2`` on the recorded K2 calls (their gates, the
    kernel's times and SDPA's), each row with its plain version's device
    time on the same operands."""
    import importlib

    k2_mod = importlib.import_module("repro_torch.kernels.decode_attention")
    plain = {key: smoke.events_ms(lambda a=args: k2_mod.paged_decode_attention_ref(*a[:5]),
                                  reps=TP_K1_TIME_REPS, spin=True)
             for key, args in seen.items()}
    rows = smoke.check_k2(f"rank {rank}", seen, fails)
    for row, plain_ms in zip(rows, plain.values()):
        row["plain_device_ms"] = plain_ms
    return rows


def tp_k1_times(smoke, seen, rank):
    """Rank 0's device times of K1 at each recorded (M, K, N), the other
    ranks held at a barrier so that the card runs one rank's launches."""
    import torch.distributed as dist

    from repro_torch.kernels import ops

    rows = []
    dist.barrier()
    if rank == 0:
        for key, (x, b, spec, _, _) in sorted(seen.items()):
            (m, k), n = x.shape[-2:], b.shape[-1]
            ms, dev_ms = smoke.timed(lambda: ops.plam_matmul_float(x, b, spec),
                                     reps=TP_K1_TIME_REPS)
            bound = (x.numel() * x.element_size() + b.numel() * b.element_size()
                     + m * n * 4) / HBM_BYTES_PER_S * 1e3
            rows.append({"m": m, "k": k, "n": n, "ms": ms, "device_ms": dev_ms,
                         "bytes_bound_ms": bound})
            log(f"  K1 M={m} K={k} N={n}: {ms:.4f} ms, device {dev_ms:.4f} ms, bytes "
                f"bound {bound:.4f} ms")
    dist.barrier()
    return rows


def tp_collective_share(smoke, cfg, model, job):
    """One more plain run with the mesh timing its collectives (the card
    synchronized around each): their host seconds inside the decode
    steps over those steps' seconds, and the collectives a decode step."""
    from repro_torch.serving import ServeOptions, build_engine

    eng = build_engine(cfg, ServeOptions(tp=job["tp"], **job["base"]), params=model)
    eng.mesh.time_collectives = True
    api, spent = eng.api, {"s": 0.0, "collective_s": 0.0, "steps": 0, "calls": 0}

    def decode(*a, **kw):
        c0, n0, t0 = eng.mesh.collective_s, sum(eng.mesh.collectives.values()), time.perf_counter()
        out = api.paged_decode_step(*a, **kw)
        spent["s"] += time.perf_counter() - t0
        spent["collective_s"] += eng.mesh.collective_s - c0
        spent["calls"] += sum(eng.mesh.collectives.values()) - n0
        spent["steps"] += 1
        return out

    eng.api = dataclasses.replace(api, paged_decode_step=decode)
    for i, p in enumerate(job["prompts"]):
        eng.submit(p, max_new_tokens=job["base"]["max_new_tokens"], arrival_step=i)
    eng.run()
    return {"decode_s": spent["s"], "decode_collective_s": spent["collective_s"],
            "decode_steps": spent["steps"],
            "per_decode_step": spent["calls"] // max(1, spent["steps"]),
            "decode_share": spent["collective_s"] / max(spent["s"], 1e-12)}


def tp_train_collectives(cfg, zero, model) -> dict:
    """The collectives of a dense model's sharded step, by hand (remat on,
    a vocab-parallel head, no kv head on two ranks).  Over ``model``: the
    embedding's sum, wo's and wd's in the forward (2L), wo's again in the
    remat recompute (which stops after the last tensor the layer's backward
    needs, the input of wd, so before wd's sum), the two ``copy_model``
    sums in the backward (2L), the head's copy once a 512-position loss
    chunk, and the gradient norm's: 5L + 2 + chunks; the head's all-gather
    a chunk, twice (the chunk's checkpoint recomputes it).  Over ``data``:
    the loss's label count and the loss; each float leaf's gradient, an
    all-gather for a bf16 one over two data ranks (``train/loop.py::
    _data_sum``), else an all-reduce; and one all-gather of the updated
    parameters a reference leaf that ZeRO-1 cuts over ``data``."""
    import torch

    n = cfg.n_layers
    chunks = -(-TRAIN_SEQ // 512)
    bf16 = (sum(p.dtype == torch.bfloat16 for p in model.parameters())
            if zero.mesh.data_size == 2 else 0)
    return {"all_reduce": 5 * n + 2 + chunks, "all_gather": 2 * chunks,
            "data_all_reduce": 2 + len(zero.layouts) - bf16,
            "data_all_gather": bf16 + sum(zero.sliced(names[0])
                                          for names in zero.by_path.values())}


def tp_train_rank(device, args, jobs):
    """One rank of phase tp_train (``launch/mesh.py::spawn``): each job on
    its mesh of the world's ranks (``Smoke.tp_train_steps`` or
    ``Smoke.tp_train_exact``), its backend and place.  Rank 0 logs."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    rank = dist.get_rank()
    out = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend()}
    with contextlib.ExitStack() as quiet:
        if rank:
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
        smoke = Smoke(args)
        for name, job in jobs.items():
            mesh = make_host_mesh(data=job["data"], model=job["model"])
            out.update(data_rank=mesh.data_rank, model_rank=mesh.model_rank)
            out[name] = getattr(smoke, f"tp_train_{job['kind']}")(job, mesh)
            gc.collect()
            torch.cuda.empty_cache()
    return out


def tp_ssm_collectives(cfg, zero, model) -> dict:
    """The collectives of a Mamba2 or hybrid model's sharded training step,
    by hand (no remat; a vocab-parallel head where the vocabulary divides
    tp).  Over ``model``, a Mamba2 layer: the gathered B and C (one
    all-gather), the gated norm's sum of squares and out_proj's partial
    sums (two all-reduces) in the forward; in the backward the norm's dot
    term, the gather's summed gradient and ``copy_model``'s (three), and
    six whole leaves summed (``sum_partial``: conv_w, conv_b, A_log, D,
    dt_bias, the norm's scale): 11 all-reduces a layer.  A shared-block
    invocation: wo's, wd's and out_proj's sums forward, the two copies'
    backward (five), and ``model_block``'s gathered gradient (one
    all-gather).  Then the embedding's sum, the head's copy a loss chunk,
    the gradient norm's; the head's all-gather a chunk and its recompute.
    Over ``data``: as ``tp_train_collectives``."""
    import torch

    n = cfg.n_layers
    inv = n // cfg.shared_attn_every if cfg.family == "hybrid" else 0
    chunks = -(-TRAIN_SEQ // 512)
    vp = int(getattr(model, "vocab_parallel", False))
    bf16 = (sum(p.dtype == torch.bfloat16 for p in model.parameters())
            if zero.mesh.data_size == 2 else 0)
    return {"all_reduce": vp + 11 * n + 5 * inv + vp * chunks + 1,
            "all_gather": n + inv + 2 * vp * chunks,
            "data_all_reduce": 2 + len(zero.layouts) - bf16,
            "data_all_gather": bf16 + sum(zero.sliced(names[0])
                                          for names in zero.by_path.values())}


def tp_ssm_rank(device, args, jobs):
    """One rank of phase tp_ssm (``launch/mesh.py::spawn``): each serving
    job (``Smoke.tp_ssm_serve``), then each training job
    (``Smoke.tp_ssm_train``), on the (data x model) mesh of the world.
    Rank 0 logs."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    rank = dist.get_rank()
    out = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend()}
    with contextlib.ExitStack() as quiet:
        if rank:
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
        smoke = Smoke(args)
        data, tp = TP_MESH
        mesh = make_host_mesh(data=data, model=tp)
        out.update(data_rank=mesh.data_rank, model_rank=mesh.model_rank)
        for name, job in jobs.items():
            out[name] = getattr(smoke, f"tp_ssm_{job['kind']}")(job, mesh)
            gc.collect()
            torch.cuda.empty_cache()
    return out


def meta_like(torch, tree):
    """``tree`` (dicts, tuples, lists) with each tensor as a meta tensor of
    its shape and dtype (a dry run's inputs)."""
    if isinstance(tree, dict):
        return {k: meta_like(torch, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(meta_like(torch, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device="meta")
    return tree


def calls(traffic) -> dict:
    """A ``Mesh.traffic`` record's calls by "<axis>/<kind>"."""
    return {k: v[0] for k, v in (traffic or {}).items()}


def tp_encdec_cfg(arch):
    """``arch`` at full width under default=plam_sim:16:1, the vlm cut to
    TP_ENCDEC_VLM_LAYERS layers (phase tp_encdec's serving)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).with_numerics("default=plam_sim:16:1")
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, n_layers=TP_ENCDEC_VLM_LAYERS)
    return cfg


def tp_encdec_f32_cfg(arch):
    """Phase tp_encdec (a)'s f32 form of ``arch`` (f32 parameters,
    activations and numerics), the vlm at TP_ENCDEC_VLM_F32_LAYERS layers."""
    cfg = tp_ssm_f32_cfg(arch)
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, n_layers=TP_ENCDEC_VLM_F32_LAYERS)
    return cfg


def tp_encdec_train_cfg(layers):
    """seamless-m4t-medium as its config gives it (its posit_quant:16:1,
    bf16) with ``layers`` encoder and ``layers`` decoder layers."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("seamless-m4t-medium"), n_layers=2 * layers,
                               enc_layers=layers, dec_layers=layers)


def tp_encdec_forward_collectives(cfg, vocab_parallel) -> dict:
    """The collectives over ``model`` of a serving forward of an encdec or
    vlm shard, by hand, as ``calls`` gives them: the f32 partial sums of
    each row-parallel projection (a transformer layer's wo and wd; an
    encoder layer's wo and wd, a decoder layer's wo, cross wo and wd), the
    vocab-parallel embedding's sum and the head's gather.  Under
    "prefill", "decode" and, for the encdec, "encode" (the encoder alone:
    the prefill runs it and then the decoder)."""
    vp = int(vocab_parallel)

    def forward(sums):
        return {"model/all-reduce": sums + vp, **({"model/all-gather": vp} if vp else {})}

    if cfg.family == "encdec":
        enc, dec = 2 * cfg.enc_layers, 3 * cfg.dec_layers
        return {"prefill": forward(enc + dec), "decode": forward(dec),
                "encode": {"model/all-reduce": enc}}
    return {"prefill": forward(2 * cfg.n_layers), "decode": forward(2 * cfg.n_layers)}


def tp_encdec_collectives(cfg, zero, model) -> dict:
    """The collectives of an encdec's or vlm's sharded training step, by
    hand (phase train's batch; the vlm's rows are its patches and tokens).
    Over ``model``, an encdec (no remat): the embedding's sum, wo's and
    wd's sums an encoder layer, wo's, the cross wo's and wd's a decoder
    layer in the forward, their ``copy_model``s' sums in the backward, the
    encoder output's one copy into every cross wk/wv, the head's copy a
    loss chunk and the gradient norm's; a vlm as a dense model with remat
    (``tp_train_collectives``: 5 a layer); either way each ``partial``
    leaf's sum; the head's all-gather a chunk and its recompute.  Over
    ``data``: as ``tp_train_collectives``."""
    import torch

    from repro_torch.models.registry import vlm_patches

    positions = TRAIN_SEQ + (vlm_patches(cfg) if cfg.family == "vlm" else 0)
    chunks = -(-positions // 512)
    vp = int(getattr(model, "vocab_parallel", False))
    partial = sum(lay.partial for lay in zero.layouts.values())
    if cfg.family == "encdec":
        layers = 4 * cfg.enc_layers + 6 * cfg.dec_layers + 1
    else:
        layers = 5 * cfg.n_layers
    bf16 = (sum(p.dtype == torch.bfloat16 for p in model.parameters())
            if zero.mesh.data_size == 2 else 0)
    return {"all_reduce": vp + layers + vp * chunks + 1 + partial,
            "all_gather": 2 * vp * chunks,
            "data_all_reduce": 2 + len(zero.layouts) - bf16,
            "data_all_gather": bf16 + sum(zero.sliced(names[0])
                                          for names in zero.by_path.values())}


def tp_encdec_rank(device, args, jobs):
    """One rank of phase tp_encdec (``launch/mesh.py::spawn``): each serving
    job (``Smoke.tp_encdec_serve``), then each training job (phase
    tp_ssm's ``Smoke.tp_ssm_train``), on the (data x model) mesh of the
    world.  Rank 0 logs."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    rank = dist.get_rank()
    out = {"rank": rank, "world": dist.get_world_size(), "backend": dist.get_backend()}
    with contextlib.ExitStack() as quiet:
        if rank:
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
        smoke = Smoke(args)
        data, tp = TP_MESH
        mesh = make_host_mesh(data=data, model=tp)
        out.update(data_rank=mesh.data_rank, model_rank=mesh.model_rank)
        run = {"serve": smoke.tp_encdec_serve, "train": smoke.tp_ssm_train}
        for name, job in jobs.items():
            out[name] = run[job["kind"]](job, mesh)
            gc.collect()
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="yi-6b depth for the serve phase, and at most the MoE models' "
                         "depth in the moe phase, yi-6b's in the static phase "
                         f"({STATIC_YI_LAYERS} by default) and the trained model's in the "
                         f"train phase ({TRAIN_LAYERS} by default) and the cut models' in the "
                         f"train_families phase (widths are never cut; "
                         "serve_paths and observe always run all 32 layers, and the static "
                         "phase's state-space models all of theirs; the archs phase's cut "
                         "models run at most this many)")
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import repro_torch from {ROOT}/src: {e}",
              file=sys.stderr)
        return 2

    smoke = Smoke(args)
    phases = args.phases.split(",")
    failed = []
    t_start = time.perf_counter()
    for phase in PHASES:
        if phase not in phases:
            continue
        log(f"== phase {phase}")
        t0 = time.perf_counter()
        try:
            getattr(smoke, f"phase_{phase}")()
            status = "ok"
        except Exception:  # noqa: BLE001 - every phase reports, the run then fails
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(phase)
            status = "FAILED"
        smoke.results["phases"][phase] = {"status": status,
                                          "seconds": time.perf_counter() - t0}
        log(f"== phase {phase} {status} in {time.perf_counter() - t0:.1f} s")
        if phase == "device" and failed:
            break
    smoke.results["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(smoke.results, f, indent=1, default=str)
    if failed or set(phases) != set(PHASES):
        log(f"chip_smoke: phases failed: {failed}" if failed else
            f"chip_smoke: partial run ({args.phases}); no result line")
        return 1
    log(json.dumps(smoke.kernels_line()))
    log(smoke.results["device"]["nvidia_smi"])
    log(json.dumps({"ok": True, "device": smoke.device_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
