#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check its kernels.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--layers N] [--phases device,kernels,serve,e2e,times]

It imports ``repro_torch`` (never JAX) and runs five phases, each on its
own lines:

1. device  — the card's name and power limit (nvidia-smi), the torch
   device, and the kernels' build from ``src/repro_torch/kernels/csrc``.
2. kernels — each CUDA kernel against its plain PyTorch version on the
   card at main-path shapes: the posit codec (K3) and the PLAM matmul
   (K1) bit for bit, the paged decode attention (K2) within a stated
   tolerance.
3. serve   — full-width yi-6b under ``default=plam_sim:16:1`` with int16
   prequantized weights serves 4 requests through ``build_engine`` ->
   ``submit`` -> ``run``; the launch counts must match 7L+1 PLAM matmuls
   and codec calls per forward and L attention calls per decode step.
4. e2e     — a 2-layer full-width model runs one prefill and 4 decode
   steps on the kernels and on the plain versions; last logits must
   agree within a stated tolerance.
5. times   — CUDA-event times of each kernel, its plain version and (for
   attention) ``scaled_dot_product_attention``, beside each kernel's bound.

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
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 CUDA-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
SMS, INT32_LANES_PER_SM = 132, 64

K1_SHAPES = [  # (K, N) of yi-6b's projections and lm_head
    (4096, 4096),    # wq, wo
    (4096, 512),     # wk, wv
    (4096, 11008),   # wg, wu
    (11008, 4096),   # wd
    (4096, 64000),   # unembed
]
RAGGED_SHAPES = [(4, 5, 3), (1, 7, 1), (3, 130, 9), (9, 257, 5), (2, 1, 2), (17, 64, 33)]
# K2 tolerances.  The kernel keeps scores, probabilities and sums in f32
# and rounds once to bf16 at the end, so against the plain version run in
# f32 it differs by that rounding (2^-9 of |out| <= 1 here) and sum order.
# The plain version at bf16 also rounds the unscaled scores (|q.k| ~ 35,
# ulp 0.25) and the softmax weights to bf16 before the weighted sum, which
# moves the output by up to a few 1e-2.
K2_TOL_F32 = 1e-2
K2_TOL_BF16 = 6e-2
# Phase 4: K1 and K3 are bit-identical to their plain versions, so the
# two runs differ only through K2's rounding (above), which the posit
# encoding of the next activations can amplify to a pattern step
# (2^-12 relative); logits are ~N(0, 1) at random init.
E2E_LOGIT_TOL = 0.1


def log(msg: str = "") -> None:
    print(msg, flush=True)


class Smoke:
    def __init__(self, args):
        import torch

        self.torch = torch
        self.args = args
        self.dev = torch.device("cuda")
        self.results = {"phases": {}}
        self.kernels = {}  # name -> the entry of the {"kernels": [...]} line
        self.launch_counts = {}
        self.clock_mhz = None

    # -- helpers -------------------------------------------------------------

    def gen(self, seed: int):
        g = self.torch.Generator(device=self.dev)
        g.manual_seed(seed)
        return g

    def events_ms(self, fn, reps: int, warmup: int = 2, flush: bool = True) -> float:
        """Mean device ms of fn() over reps calls, each after an L2 flush."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        scrub = torch.empty(64 << 20, dtype=torch.int32, device=self.dev) if flush else None
        total = 0.0
        for _ in range(reps):
            if scrub is not None:
                scrub.zero_()  # 256 MB: evicts the 50 MB L2
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / reps

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
        from repro_torch.kernels.decode_attention import (
            paged_decode_attention_kernel,
            paged_decode_attention_ref,
        )
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
        k3_ok = not failures
        log(f"K3 posit codec vs plain: {'bit-identical' if k3_ok else failures}")

        # K1 — main-path shapes, int16 B (and int32 B for one shape)
        n_before = len(failures)
        for m in (4, 64):
            for k, n in K1_SHAPES:
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
        # K1 — the reference's ragged shapes with zero and NaR lanes
        import numpy as np

        for shape in RAGGED_SHAPES:
            m, k, n = shape
            rng = np.random.default_rng(hash(shape) & 0xFFFF)
            a = rng.integers(0, 1 << 16, (m, k)).astype(np.int32)
            b = rng.integers(0, 1 << 16, (k, n)).astype(np.int32)
            a.flat[:: max(1, a.size // 7)] = P16.nar
            b.flat[:: max(1, b.size // 5)] = 0
            at, bt_ = torch.from_numpy(a).to(self.dev), torch.from_numpy(b).to(self.dev)
            same(f"plam_matmul ragged {shape}", plam_matmul(at, bt_, P16),
                 plam_matmul(at, bt_, P16, use_kernel=False))
        k1_ok = len(failures) == n_before
        log(f"K1 plam_matmul vs plain: {'bit-identical' if k1_ok else failures[n_before:]}")

        # K2 — ragged lengths, permuted block tables, scratch block 0
        b_, h, kv, hd, bs = 4, 32, 4, 128, 16
        lengths = [1, 15, 16, 77]
        need = [max(1, -(-n // bs)) for n in lengths]
        max_blk = max(need)
        nb = 1 + sum(need) + 3
        perm = torch.randperm(nb - 1, generator=g, device=self.dev) + 1
        tables = torch.zeros((b_, max_blk), dtype=torch.int32, device=self.dev)
        pos = 0
        for i, c in enumerate(need):
            tables[i, :c] = perm[pos:pos + c]
            pos += c
        q = torch.randn((b_, h, hd), generator=g, device=self.dev).to(torch.bfloat16)
        kp = torch.randn((nb, bs, kv, hd), generator=g, device=self.dev).to(torch.bfloat16)
        vp = torch.randn((nb, bs, kv, hd), generator=g, device=self.dev).to(torch.bfloat16)
        lens = torch.tensor(lengths, dtype=torch.int32, device=self.dev)
        got = paged_decode_attention_kernel(q, kp, vp, tables, lens).float()
        ref16 = paged_decode_attention_ref(q, kp, vp, tables, lens).float()
        ref32 = paged_decode_attention_ref(q.float(), kp.float(), vp.float(), tables, lens)
        err16 = float((got - ref16).abs().max())
        err32 = float((got - ref32).abs().max())
        finite = bool(torch.isfinite(got).all())
        k2_ok = finite and err32 <= K2_TOL_F32 and err16 <= K2_TOL_BF16
        if not k2_ok:
            failures.append(f"paged attention: err_f32 {err32} err_bf16 {err16} finite {finite}")
        log(f"K2 paged_decode_attention: max_abs_err vs plain f32 {err32:.3e} "
            f"(tol {K2_TOL_F32}), vs plain bf16 {err16:.3e} (tol {K2_TOL_BF16})")
        self.kernel_err = {"plam_matmul": 0.0 if k1_ok else None,
                           "posit_codec": 0.0 if k3_ok else None,
                           "paged_decode_attention": err32}
        self.results["kernels"] = {"k1_bit_identical": k1_ok, "k3_bit_identical": k3_ok,
                                   "k2_err_f32": err32, "k2_err_bf16": err16,
                                   "failures": failures}
        if failures:
            raise AssertionError("; ".join(failures))

    # -- phase 3 -------------------------------------------------------------

    def yi_cfg(self, n_layers):
        from repro_torch.configs import get_config

        cfg = get_config("yi-6b")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        return cfg.with_numerics("default=plam_sim:16:1")

    def phase_serve(self):
        torch = self.torch
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
        n_int16 = sum(p.numel() for p in eng.model.parameters() if p.dtype == torch.int16)
        log(f"engine build {build_s:.1f} s: {build_encodes} weight encodes (K3), "
            f"{n_int16 / 1e9:.3f} G int16 weights, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        if build_encodes != 7 * layers + 1:
            raise AssertionError(f"expected {7 * layers + 1} weight encodes, got {build_encodes}")

        g = torch.Generator().manual_seed(7)
        lens = torch.randint(32, 65, (4,), generator=g).tolist()
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist() for n in lens]
        _lib.reset_launches()  # the main path's run starts here
        t0 = time.perf_counter()
        handles = [eng.submit(p, arrival_step=i, **opts.submit_kwargs())
                   for i, p in enumerate(prompts)]
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_lib.launches)
        self.launch_counts = counts
        st = eng.stats
        forwards = st.prefills + st.decode_steps
        decode_tokens = st.generated_tokens - st.prefills
        log(f"served {len(done)} requests (prompt lens {lens}) in {st.steps} steps, "
            f"{wall:.2f} s wall: prefill {st.prefill_s:.2f} s over {st.prefills} prefills, "
            f"decode {st.decode_s:.2f} s over {st.decode_steps} steps "
            f"({decode_tokens / st.decode_s:.2f} decode tok/s), "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"launches: {counts} (forwards {forwards}, decode steps {st.decode_steps})")
        expect = {"plam_matmul": (7 * layers + 1) * forwards,
                  "posit_codec": (7 * layers + 1) * forwards,
                  "paged_decode_attention": layers * st.decode_steps}
        bad = {k: (counts[k], v) for k, v in expect.items() if counts[k] != v}
        outs = [done[h.rid] for h in handles]
        valid = all(len(o) == 16 and all(0 <= t < cfg.vocab for t in o) for o in outs)
        for h in handles:
            log(f"  req {h.rid}: {done[h.rid]}")
        profile = self.profile_decode(eng, prompts)
        self.results["serve"] = {
            "layers": layers, "prompt_lens": lens, "steps": st.steps,
            "prefills": st.prefills, "decode_steps": st.decode_steps,
            "prefill_s": st.prefill_s, "decode_s": st.decode_s, "wall_s": wall,
            "decode_tok_per_s": decode_tokens / st.decode_s,
            "step_p50_s": st.latency_p50(), "step_p95_s": st.latency_p95(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "engine_build_s": build_s, "launches": counts, "expected": expect,
            "outputs": outs, "decode_profile": profile}
        del eng
        torch.cuda.empty_cache()
        if bad:
            raise AssertionError(f"launch counts (got, expected): {bad}")
        if not valid:
            raise AssertionError("a request did not return 16 valid tokens")

    def profile_decode(self, eng, prompts):
        """Device time by kernel over two decode steps with all 4 slots
        busy (torch.profiler), after the counted run; idle share = 1 -
        device busy time / wall time of the two steps."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            log("decode profile: this torch cannot trace the card (not measured)")
            return None
        for p in prompts:
            eng.submit(p, max_new_tokens=4, arrival_step=eng.current_step)
        eng.step()  # admits and prefills all four, then one decode
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
            return None
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log(f"decode profile, 2 steps x 4 slots: wall {wall_us / 1e3:.1f} ms, device busy "
            f"{busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f}")
        for name, us in top:
            log(f"  {us / busy:6.1%}  {us / 1e3:8.2f} ms  {name[:90]}")
        return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
                "idle_share": 1 - busy / wall_us,
                "top": [[name, us / 1e3] for name, us in top]}

    # -- phase 4 -------------------------------------------------------------

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
        if not finite or err > E2E_LOGIT_TOL or min(used.values()) == 0:
            raise AssertionError(f"e2e: err {err} finite {finite} launches {used}")

    # -- phase 5 -------------------------------------------------------------

    def phase_times(self):
        torch = self.torch
        import torch.nn.functional as F

        from repro_torch.kernels.decode_attention import (
            gather_pages,
            paged_decode_attention_kernel,
            paged_decode_attention_ref,
        )
        from repro_torch.kernels.plam_matmul import plam_matmul
        from repro_torch.kernels.posit_codec import posit_encode
        from repro_torch.numerics import P16

        g = self.gen(5)
        rows = []

        def add(name, shape, ms, plain_ms, bytes_, ops, op_rate, library_ms=None):
            t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
            t_ops = ops / op_rate * 1e3
            row = {"name": name, "shape": shape, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": library_ms}
            rows.append(row)
            log(f"time {name} {shape}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
                f"{row['bound_ms']:.4f} ms by {row['bound_by']}"
                + (f", library {library_ms:.4f} ms" if library_ms is not None else "") + ")")
            return row

        int_rate = self.int32_ops_per_s()
        # K1 at the decode shapes (M = 4) and one prefill shape (M = 64)
        k1_main = None
        for m, (k, n) in [(4, s) for s in K1_SHAPES] + [(64, (4096, 11008))]:
            a = posit_encode(torch.randn((m, k), generator=g, device=self.dev), P16)
            b = posit_encode(torch.randn((k, n), generator=g, device=self.dev) * k ** -0.5,
                             P16, out_dtype=torch.int16)
            ms = self.events_ms(lambda: plam_matmul(a, b, P16), reps=10)
            plain = self.events_ms(lambda: plam_matmul(a, b, P16, use_kernel=False),
                                   reps=1, warmup=0)
            row = add("plam_matmul", f"M={m} K={k} N={n} B=int16", ms, plain,
                      m * k * 4 + k * n * 2 + m * n * 4, m * k * n, int_rate)
            if (m, k, n) == (4, 4096, 11008):
                k1_main = row
            del a, b
        # K3 at the activation shapes (bf16 -> int32) and one weight (-> int16)
        k3_main = None
        for shape, od in [((4, 4096), torch.int32), ((64, 11008), torch.int32),
                          ((4096, 11008), torch.int16)]:
            x = torch.randn(shape, generator=g, device=self.dev).to(torch.bfloat16)
            ms = self.events_ms(lambda: posit_encode(x, P16, out_dtype=od), reps=20)
            plain = self.events_ms(
                lambda: posit_encode(x, P16, out_dtype=od, use_kernel=False), reps=2)
            out_b = 4 if od == torch.int32 else 2
            row = add("posit_codec", f"encode {list(shape)} bf16->{str(od)[6:]}", ms, plain,
                      x.numel() * (2 + out_b), x.numel(), int_rate)
            if shape == (4, 4096):
                k3_main = row
        # K2 at the serving shape: 4 sequences of yi-6b heads, bf16 pool
        b_, h, kv, hd, bs = 4, 32, 4, 128, 16
        lengths = [48, 60, 70, 79]
        need = [-(-n // bs) for n in lengths]
        max_blk, nb = max(need), 1 + sum(need)
        tables = torch.zeros((b_, max_blk), dtype=torch.int32, device=self.dev)
        perm = torch.randperm(nb - 1, generator=g, device=self.dev) + 1
        pos = 0
        for i, c in enumerate(need):
            tables[i, :c] = perm[pos:pos + c]
            pos += c
        q = torch.randn((b_, h, hd), generator=g, device=self.dev).to(torch.bfloat16)
        kp = torch.randn((nb, bs, kv, hd), generator=g, device=self.dev).to(torch.bfloat16)
        vp = torch.randn((nb, bs, kv, hd), generator=g, device=self.dev).to(torch.bfloat16)
        lens = torch.tensor(lengths, dtype=torch.int32, device=self.dev)
        ms = self.events_ms(lambda: paged_decode_attention_kernel(q, kp, vp, tables, lens),
                            reps=50)
        plain = self.events_ms(lambda: paged_decode_attention_ref(q, kp, vp, tables, lens),
                               reps=20)
        # library yardstick: SDPA over the pre-gathered contiguous cache
        kc = gather_pages(kp, tables).transpose(1, 2).contiguous()  # [B, kv, S, hd]
        vc = gather_pages(vp, tables).transpose(1, 2).contiguous()
        s = kc.shape[2]
        mask = (torch.arange(s, device=self.dev)[None, :] < lens[:, None])[:, None, None, :]
        qs = q[:, :, None, :]
        try:
            F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask, enable_gqa=True)
            lib_kv, lib_kw = (kc, vc), {"enable_gqa": True}
        except TypeError:  # torch without enable_gqa: expand kv heads first
            lib_kv = (kc.repeat_interleave(h // kv, 1), vc.repeat_interleave(h // kv, 1))
            lib_kw = {}
        lib_ms = self.events_ms(
            lambda: F.scaled_dot_product_attention(qs, *lib_kv, attn_mask=mask, **lib_kw),
            reps=50)
        ctx = sum(lengths)
        k2_main = add("paged_decode_attention", f"B=4 H=32 kv=4 hd=128 bs=16 lens={lengths}",
                      ms, plain,
                      q.numel() * 2 * 2 + 2 * ctx * kv * hd * 2 + tables.numel() * 4 + b_ * 4,
                      4 * ctx * h * hd, F32_FLOPS, library_ms=lib_ms)
        self.results["times"] = rows
        self.kernels = {
            "plam_matmul": (k1_main, "src/repro_torch/kernels/csrc/plam_matmul.cu",
                            "src/repro/kernels/plam_matmul.py:123"),
            "paged_decode_attention": (
                k2_main, "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
                "src/repro/kernels/decode_attention.py:184"),
            "posit_codec": (k3_main, "src/repro_torch/kernels/csrc/posit_codec.cu",
                            "src/repro/kernels/posit_codec.py:57"),
        }

    def kernels_line(self):
        out = []
        for name, (row, source, replaces) in self.kernels.items():
            out.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": self.launch_counts.get(name, 0),
                "max_abs_err": self.kernel_err.get(name),
                "ms": row["ms"], "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": row["shape"],
            })
        return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="yi-6b depth for the serve phase (widths are never cut)")
    ap.add_argument("--phases", default="device,kernels,serve,e2e,times")
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
    for phase in ["device", "kernels", "serve", "e2e", "times"]:
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
    if failed or set(phases) != {"device", "kernels", "serve", "e2e", "times"}:
        log(f"chip_smoke: phases failed: {failed}" if failed else
            f"chip_smoke: partial run ({args.phases}); no result line")
        return 1
    log(json.dumps(smoke.kernels_line()))
    log(smoke.results["device"]["nvidia_smi"])
    log(json.dumps({"ok": True, "device": smoke.device_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
