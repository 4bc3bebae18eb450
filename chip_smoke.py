#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check its kernels.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--layers N]
                          [--phases device,kernels,conformance,serve,serve_paths,observe,e2e,times]

It imports ``repro_torch`` (never JAX) and runs eight phases, each on its
own lines:

1. device      — the card's name and power limit (nvidia-smi), the torch
   device, and the kernels' build from ``src/repro_torch/kernels/csrc``.
2. kernels     — each CUDA kernel against its plain PyTorch version on
   the card at its paths' shapes: the posit codec (K3; its encode's bf16
   table at eight specs, and all 65,536 bf16 patterns through its table
   and computed paths, at odd offsets and at the table threshold's
   edges), the PLAM matmul
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
   their shared core (0 included) in every dtype pair they take, and
   over seeded random shapes with NaN in every element they must not
   read.  Then K5's public entry point runs once per yi-6b layer at
   yi-6b's widths (K5 has no serving path).
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
7. e2e         — a 2-layer full-width model runs one prefill and 4
   decode steps on the kernels and on the plain versions; last logits
   must agree within a stated tolerance.
8. times       — CUDA-event times of each kernel, its plain version and
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
   same bytes; its decode and quantize at 2^24 and 4,096 lanes beside
   their bytes bound and a copy of the same bytes.  K1 is also timed at
   the chunk width and the verify rows (M = 32, 20).  K2 is timed at
   the serving shape and at a long paged context, and K5 also at other
   split sizes.

It exits non-zero if any phase fails, if no CUDA device is present, or if
``repro_torch`` cannot be imported.  Its last line is
``{"ok": true, "device": {...}}`` and nothing is printed there otherwise.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
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

PHASES = ["device", "kernels", "conformance", "serve", "serve_paths", "observe", "e2e",
          "times"]

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 CUDA-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SMS, INT32_LANES_PER_SM = 132, 64
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
# its plain version (wk/wv: 64 blocks; wg/wu: the grid capped at 2 x SMs;
# the unembed: the longest loop; a copy of the test file's WEIGHT_SHAPES,
# held equal there), and the lanes a plain call takes at a time (it holds
# int64 temporaries of every lane)
K3_WEIGHT_SHAPES = [(4096, 512), (4096, 11008), (4096, 64000)]
K3_PLAIN_LANES = 1 << 25
# the K3_TIMES shapes whose host time per call is read: the table path
# (wk/wv) and the computed path (a decode activation)
K3_HOST_SHAPES = [(4096, 512), (4, 4096)]
# K3's decode and quantize (the conformance oracle's): (operation, input)
# at each of K3_OTHER_LANES, Posit<16,1> (2^24 lanes, and the 4,096 lanes
# of a Posit<16,1> vector file)
K3_OTHER_TIMES = [("decode", "int16"), ("decode", "int32"), ("quantize", "f32"),
                  ("quantize", "bf16")]
K3_OTHER_LANES = (1 << 24, 4096)
# the table path's fill probe (Smoke.time_table_fill): its shapes and
# outputs, and the lanes a block of the one variation the design allows
K3_FILL_SHAPES = [((4096, 512), "int16"), ((4096, 11008), "int16"),
                  ((4096, 11008), "int32"), ((4096, 64000), "int16")]
K3_FILL_VARIANT_LANES = 65536
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
        from repro_torch.numerics import P16

        def bits(t):
            return t.view(torch.int32) if t.dtype == torch.float32 else t

        failures = []

        def same(what, got, want):
            ok = got.shape == want.shape and torch.equal(bits(got), bits(want))
            if not ok:
                n_bad = int((bits(got) != bits(want)).sum()) if got.shape == want.shape else -1
                failures.append(f"{what}: {n_bad} lanes differ")
            return ok

        # K3 — decode over all 65,536 patterns, as int32 and as int16
        pats = torch.arange(1 << 16, dtype=torch.int32, device=self.dev)
        same("decode int32", posit_decode(pats, P16), posit_decode(pats, P16, use_kernel=False))
        p16 = ((pats ^ 0x8000) - 0x8000).to(torch.int16)
        same("decode int16", posit_decode(p16, P16), posit_decode(p16, P16, use_kernel=False))
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
        k3_ok = not failures
        log(f"K3 posit codec vs plain: {'bit-identical' if k3_ok else failures} (decode over "
            f"all patterns; encode and quantize over the f32 sweep and the activation shapes, "
            f"f32 and bf16; {paths['calls']} encode calls over both paths)")

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

        k2 = self.check_paged_attention(failures)
        k4_ok = self.check_posit_mul(same, failures)
        k5 = self.check_decode_attention(failures)
        canaries = self.check_canaries(failures)
        self.kernel_err = {"plam_matmul": 0.0 if k1_ok else None,
                           "posit_codec": 0.0 if k3_ok else None,
                           "paged_decode_attention": k2["err_f32"],
                           "posit_mul": 0.0 if k4_ok else None,
                           "decode_attention": k5["err_f32"]}
        self.results["kernels"] = {"k1_bit_identical": k1_ok, "k1_fused": fused,
                                   "k3_bit_identical": k3_ok, "k3_paths": paths,
                                   "k2": k2,
                                   "k4_bit_identical": k4_ok, "k5": k5,
                                   "canaries": canaries,
                                   "failures": failures}
        if failures:
            raise AssertionError("; ".join(failures))

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
        grid capped at 2 x SMs, ~21 and ~121 strides on 132 SMs) at
        Posit<16,1>, the plain version computed K3_PLAIN_LANES at a
        time."""
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
            rows = max(1, K3_PLAIN_LANES // shape[1])
            for od in (torch.int16, torch.int32):
                want = torch.cat([encode_plain(w[r:r + rows], P16, od)
                                  for r in range(0, shape[0], rows)])
                same(f"encode weight {list(shape)} bf16 -> {str(od)[6:]}",
                     posit_encode(w, P16, out_dtype=od), want)
                calls += 1
                del want
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
        for h, kv, hd in [(48, 4, 128), (16, 1, 256), (8, 8, 64), (8, 4, 32), (4, 2, 16)]:
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
        if build_encodes != 7 * layers + 1:
            raise AssertionError(f"expected {7 * layers + 1} weight encodes, got {build_encodes}")
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
        expect = {"plam_matmul": (7 * layers + 1) * forwards,
                  "posit_codec": 0,
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
        step_expect = {"plam_matmul": 7 * layers + 1, "posit_codec": 0,
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
        per_forward = 7 * layers + 1
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
        by_name = {}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0)
            if us > 0:
                by_name[evt.key] = by_name.get(evt.key, 0.0) + us
        busy = sum(by_name.values())
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
        kernels = {name: us for name, us in by_name.items() if not name.startswith("aten::")}
        k1_us = sum(us for name, us in kernels.items() if "plam_matmul" in name)
        k3_us = sum(us for name, us in kernels.items() if "encode_" in name and "kernel" in name)
        copy_us = sum(us for name, us in kernels.items() if "copy" in name)
        log(f"  K1 {k1_us / 1e3:.3f} ms, K3 (weight encodes) {k3_us / 1e3:.3f} ms, copy "
            f"kernels {copy_us / 1e3:.3f} ms over the 2 steps")
        return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
                "idle_share": 1 - busy / wall_us,
                "k2_ms": k2_us / 1e3, "k2_share": k2_us / busy,
                "k1_ms": k1_us / 1e3, "k3_ms": k3_us / 1e3, "copy_ms": copy_us / 1e3,
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

    def serve_run(self, name, cfg, model, opts, prompts, priorities=None):
        """Serve ``prompts`` (one step apart, the serve phase's 16 new tokens;
        ``priorities``, one a request, else 0) on an engine over ``model``,
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
        handles = [eng.submit(p, max_new_tokens=16, arrival_step=i, priority=pr)
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
               "step_p50_s": st.latency_p50(), "launches": counts, "calls": calls,
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

    def forward_gates(self, run, layers):
        """Launches per forward: 7L+1 K1 on every forward, L K2 on a
        one-token decode step and none on a prefill, chunk or verify
        forward, and nothing else (no K3: the weights are int16 patterns
        and K1 encodes the activations)."""
        bad = []
        for kind, m, got, _ in run["calls"]:
            want = {k: 0 for k in got}
            want["plam_matmul"] = 7 * layers + 1
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
        if (not finite or err > E2E_LOGIT_TOL or min(used[k] for k in served) == 0
                or used["posit_codec"] != 0):
            raise AssertionError(f"e2e: err {err} finite {finite} launches {used}")

    # -- phase 8 -------------------------------------------------------------

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
        self.time_fused_on_serve_activations()
        k3_main = self.time_encode(add, int_rate)
        self.time_decode_quantize(add)
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

    def time_decode_quantize(self, add):
        """K3's decode and quantize (the conformance oracle's calls) at
        K3_OTHER_TIMES and K3_OTHER_LANES, Posit<16,1>: window and spun,
        beside the bytes bound (each input read once, each f32 output
        written once), the plain version and a copy of the same bytes (a
        torch conversion of the input into the f32 output)."""
        torch = self.torch
        from repro_torch.kernels.posit_codec import posit_decode, posit_quantize
        from repro_torch.numerics import P16

        g = self.gen(21)
        for lanes in K3_OTHER_LANES:
            for op, kind in K3_OTHER_TIMES:
                if op == "decode":
                    x = torch.randint(0, 1 << 16, (lanes,), generator=g, device=self.dev,
                                      dtype=torch.int32)
                    if kind == "int16":
                        x = ((x ^ 0x8000) - 0x8000).to(torch.int16)
                    fn = posit_decode
                else:
                    x = torch.randn((lanes,), generator=g, device=self.dev)
                    if kind == "bf16":
                        x = x.to(torch.bfloat16)
                    fn = posit_quantize
                ms = self.timed(lambda: fn(x, P16), reps=20)
                plain = self.events_ms(lambda: fn(x, P16, use_kernel=False), reps=2)
                dst = torch.empty((lanes,), dtype=torch.float32, device=self.dev)
                copy_ms = self.timed(lambda: dst.copy_(x), reps=20)
                row = add("posit_codec", f"{op} [{lanes}] {kind}->float32", ms, plain,
                          lanes * (x.element_size() + 4), 0, 1.0)
                row.update({"copy_ms": copy_ms[0], "copy_device_ms": copy_ms[1]})
                log(f"  copy of the same bytes: {copy_ms[0]:.4f} ms, device "
                    f"{copy_ms[1]:.4f} ms")
                del x, dst
        torch.cuda.empty_cache()

    def time_table_fill(self):
        """The table fill's share of K3's table path, and the one variation
        its design allows (K3_FILL_VARIANT_LANES lanes a block): this
        tree's posit_codec.cu beside two variants made from its text, one
        with the fill taken out (its output is garbage; only its time is
        read) and one with more lanes a block, each built into a library of
        its own under build/ (both nvcc at once) and called through
        posit_encode_launch on one input and output at K3_FILL_SHAPES
        (Posit<16,1>), in turns (design, variants, variants, design), spun
        after an L2 flush.  These launches pass no wrapper: no count moves."""
        torch = self.torch
        import ctypes

        from repro_torch.kernels import _lib
        from repro_torch.kernels.posit_codec import bf16_table
        from repro_torch.numerics import P16

        with open(K3_SOURCE) as f:
            src = f.read()
        fill = "for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x) smem[i] = src[i];"
        lanes = "constexpr int kTableLanesPerBlock = 32768;"
        if fill not in src or lanes not in src:
            raise AssertionError("table fill probe: posit_codec.cu's fill loop or lanes a "
                                 "block, which the probe rewrites, changed")
        texts = {"no fill": src.replace(fill, "(void)src;"),
                 f"{K3_FILL_VARIANT_LANES} lanes a block":
                     src.replace(lanes, lanes.replace("32768", str(K3_FILL_VARIANT_LANES)))}
        out_dir = os.path.join(ROOT, "build", "k3_fill_probe")
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        try:
            for i, (name, text) in enumerate(texts.items()):
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
                    raise RuntimeError(f"table fill probe: nvcc failed on {name}:\n{out}")
                lib = ctypes.CDLL(so)
                lib.posit_encode_launch.argtypes = _lib._SIGNATURES["posit_encode_launch"]
                lib.posit_encode_launch.restype = ctypes.c_int
                libs[name] = lib
        finally:
            for _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        log(f"K3 table fill probe: variants built in {time.perf_counter() - t0:.1f} s")
        table = bf16_table(P16, self.dev)
        stream = torch.cuda.current_stream().cuda_stream
        g = self.gen(19)
        rows = []
        for shape, od_name in K3_FILL_SHAPES:
            od = getattr(torch, od_name)
            x = self.k3_input(g, shape, "bf16")
            out = torch.empty(shape, dtype=od, device=self.dev)

            def call(lib):
                def fn():
                    err = lib.posit_encode_launch(
                        x.data_ptr(), _lib.DTYPE_CODES[x.dtype], out.data_ptr(),
                        _lib.DTYPE_CODES[od], x.numel(), P16.n, P16.es, table.data_ptr(),
                        stream)
                    if err:
                        raise RuntimeError(f"table fill probe: launch failed ({err})")
                return fn

            turns = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                turns[name].append(self.events_ms(call(libs[name]), reps=30, spin=True))
            design = sum(turns["design"]) / 2
            share = (design - sum(turns["no fill"]) / 2) / design
            rows.append({"shape": list(shape), "out": od_name, "device_ms": turns,
                         "fill_share": share})
            log(f"  table fill probe {list(shape)} bf16->{od_name}, spun ms in turns: "
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="yi-6b depth for the serve phase (widths are never cut; "
                         "serve_paths and observe always run all 32 layers)")
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
