"""Uniform oracle interface over every posit/PLAM implementation of the port.

An :class:`Impl` exposes the five conformance operations —

* ``encode(x, spec)``    : float32 values  -> posit patterns (int32)
* ``decode(bits, spec)`` : posit patterns  -> float32 values
* ``quantize(x, spec)``  : float32 values  -> float32 posit-grid values
* ``exact_mul(pa, pb, spec)`` : exact posit product patterns
* ``plam_mul(pa, pb, spec)``  : PLAM approximate product patterns

— over host numpy arrays, so the differential fuzzer can compare any two
implementations element-wise wherever each one runs.  The families
(port of ``repro/conformance/oracles.py``, TPU names mapped to devices):

* :class:`GoldenImpl`  — the pure-Python golden model (``numerics/golden.py``),
  batch-evaluated through a per-pattern field cache.
* :class:`TorchImpl`   — the vectorized PyTorch numerics (``numerics/posit.py``,
  ``numerics/plam.py``) on the impl's device; ``variant="logfix"`` swaps in
  the Fig. 4 single-word datapath for ``plam_mul``.
* :class:`TableImpl`   — the exhaustive-table codec (``numerics/table.py``)
  on the impl's device, plus an independent float64 numpy formulation of
  both multipliers.
* :class:`KernelImpl`  — the kernel wrappers (``kernels/posit_codec.py``):
  K3 for the codec ops, K4 for the multipliers.  ``cuda`` launches the
  CUDA kernels; ``kernel_plain`` runs their plain versions.

:class:`FaultyImpl` wraps any of them and XORs a bit into one op's
output: the meta-testing hook that proves the fuzzer catches single-bit
faults in any layer.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch import numerics as tn
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import posit_codec as pc
from repro_torch.numerics import PositSpec, golden
from repro_torch.numerics.plam import exact_mul_supported

OPS = ("encode", "decode", "quantize", "exact_mul", "plam_mul")
CODEC_OPS = ("encode", "decode", "quantize")
MUL_OPS = ("exact_mul", "plam_mul")


def _ops_for(spec: PositSpec):
    """Every op, less exact_mul where its product word would not fit."""
    if not exact_mul_supported(spec):
        return ("encode", "decode", "quantize", "plam_mul")
    return OPS


class Impl:
    """Base class: one named implementation of the conformance ops."""

    name = "base"

    def ops(self, spec: PositSpec):
        """The subset of OPS this impl supports for ``spec``."""
        return OPS

    # each method: numpy in, numpy out (int32 patterns / float32 values)
    def encode(self, x, spec: PositSpec):
        raise NotImplementedError

    def decode(self, bits, spec: PositSpec):
        raise NotImplementedError

    def quantize(self, x, spec: PositSpec):
        raise NotImplementedError

    def exact_mul(self, pa, pb, spec: PositSpec):
        raise NotImplementedError

    def plam_mul(self, pa, pb, spec: PositSpec):
        raise NotImplementedError

    def run(self, op: str, inputs, spec: PositSpec):
        return getattr(self, op)(*inputs, spec)


def outputs_equal(a, b):
    """Element-wise output agreement: exact bits, NaN == NaN."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.dtype.kind == "f":
        both_nan = np.isnan(a) & np.isnan(b)
        av = a.astype(np.float32).view(np.uint32)
        bv = b.astype(np.float32).view(np.uint32)
        return (av == bv) | both_nan
    return np.asarray(a, np.int64) == np.asarray(b, np.int64)


# ---------------------------------------------------------------------------
# golden (pure Python, field-cached batch loops)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=16)
def _golden_fields(n: int, es: int):
    """(sign, k, e, f) per pattern, None for zero/NaR — the batch cache."""
    nar = 1 << (n - 1)
    return tuple(
        None if p in (0, nar) else golden.decode_fields_py(p, n, es)
        for p in range(1 << n)
    )


@lru_cache(maxsize=16)
def _golden_values(n: int, es: int):
    return tuple(golden.decode_py(p, n, es) for p in range(1 << n))


class GoldenImpl(Impl):
    name = "golden"

    def encode(self, x, spec):
        n, es = spec.n, spec.es
        return np.array(
            [golden.encode_py(float(v), n, es) for v in np.ravel(x)], np.int32
        ).reshape(np.shape(x))

    def decode(self, bits, spec):
        vals = _golden_values(spec.n, spec.es)
        mask = spec.mask_n
        return np.array(
            [vals[int(b) & mask] for b in np.ravel(bits)], np.float32
        ).reshape(np.shape(bits))

    def quantize(self, x, spec):
        return self.decode(self.encode(x, spec), spec)

    def _mul(self, pa, pb, spec, plam: bool):
        n, es = spec.n, spec.es
        nar = spec.nar
        mask = spec.mask_n
        fields = _golden_fields(n, es)
        enc = golden.encode_py
        out = np.empty(np.shape(pa), np.int32).ravel()
        pa_flat = np.ravel(np.asarray(pa, np.int64) & mask)
        pb_flat = np.ravel(np.asarray(pb, np.int64) & mask)
        for i in range(out.shape[0]):
            a, b = int(pa_flat[i]), int(pb_flat[i])
            if a == nar or b == nar:
                out[i] = nar
                continue
            if a == 0 or b == 0:
                out[i] = 0
                continue
            sa, ka, ea, fa = fields[a]
            sb, kb, eb, fb = fields[b]
            s = sa ^ sb
            scale = (ka + kb) * (1 << es) + (ea + eb)
            if plam:
                f = fa + fb  # eq. (17)
                if f >= 1.0:  # eqs. (19)-(21)
                    f -= 1.0
                    scale += 1
                val = 2.0**scale * (1.0 + f)
            else:
                val = 2.0**scale * (1.0 + fa) * (1.0 + fb)
            out[i] = enc(-val if s else val, n, es)
        return out.reshape(np.shape(pa))

    def exact_mul(self, pa, pb, spec):
        return self._mul(pa, pb, spec, plam=False)

    def plam_mul(self, pa, pb, spec):
        return self._mul(pa, pb, spec, plam=True)


# ---------------------------------------------------------------------------
# devices: numpy in, a tensor on the impl's device, numpy out
# ---------------------------------------------------------------------------


class _DeviceImpl(Impl):
    def __init__(self, device: DeviceLike = "cpu"):
        self.device = torch.device(device)

    def _t(self, x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(self.device)

    def _patterns(self, t, spec):
        return t.cpu().numpy() & spec.mask_n

    def _floats(self, t):
        return t.cpu().numpy()


class TorchImpl(_DeviceImpl):
    """numerics/posit.py + numerics/plam.py on the impl's device
    (``variant="logfix"`` runs only plam_mul, on the Fig. 4 datapath)."""

    def __init__(self, variant: str = "field", device: DeviceLike = "cpu"):
        super().__init__(device)
        if variant not in ("field", "logfix"):
            raise ValueError(f"unknown variant {variant!r}")
        self.variant = variant
        self.name = "torch" if variant == "field" else "torch_logfix"

    def ops(self, spec):
        if self.variant == "logfix":
            return ("plam_mul",)
        return _ops_for(spec)

    def encode(self, x, spec):
        return self._patterns(tn.encode(self._t(x, np.float32), spec), spec)

    def decode(self, bits, spec):
        return self._floats(tn.decode(self._t(bits, np.int32), spec))

    def quantize(self, x, spec):
        return self._floats(tn.decode(tn.encode(self._t(x, np.float32), spec), spec))

    def exact_mul(self, pa, pb, spec):
        out = tn.exact_mul(self._t(pa, np.int32), self._t(pb, np.int32), spec)
        return self._patterns(out, spec)

    def plam_mul(self, pa, pb, spec):
        fn = tn.plam_mul_logfix if self.variant == "logfix" else tn.plam_mul
        return self._patterns(fn(self._t(pa, np.int32), self._t(pb, np.int32), spec), spec)


# ---------------------------------------------------------------------------
# exhaustive-table codec + float64 table multipliers
# ---------------------------------------------------------------------------


@lru_cache(maxsize=16)
def _table_f64(n: int, es: int):
    vals = np.asarray(golden.all_values(n, es), np.float64)
    mids = np.asarray(golden.thresholds(n, es), np.float64)
    return vals, mids


class TableImpl(_DeviceImpl):
    """table.py codec on the impl's device; multipliers re-derived from the
    f64 value tables in numpy.

    The multiplier path is an independent formulation: decode both
    operands through the value table, split magnitude into
    (scale, fraction) with ``np.frexp`` (exact in f64), combine per the
    exact product or the PLAM fraction-sum, and encode by binary search
    over the threshold table with ties-to-even-pattern.
    """

    name = "table"

    def ops(self, spec):
        return OPS if spec.n <= 16 else ()

    def encode(self, x, spec):
        return self._patterns(tn.encode_table(self._t(x, np.float32), spec), spec)

    def decode(self, bits, spec):
        return self._floats(tn.decode_table(self._t(bits, np.int32), spec))

    def quantize(self, x, spec):
        return self.decode(self.encode(x, spec), spec)

    def _decode_f64(self, p, spec):
        vals, _ = _table_f64(spec.n, spec.es)
        mask, nar = spec.mask_n, spec.nar
        p = np.asarray(p, np.int64) & mask
        sign = (p >> (spec.n - 1)) & 1
        mag = np.where(sign == 1, (-p) & mask, p)
        body = mag & spec.maxpos_body
        v = vals[np.clip(body - 1, 0, vals.shape[0] - 1)]
        v = np.where(sign == 1, -v, v)
        v = np.where(p == 0, 0.0, v)
        return v, p == nar

    def _encode_f64(self, a, sign, spec):
        """|value| f64 + sign -> pattern, threshold search w/ pattern-RNE."""
        _, mids = _table_f64(spec.n, spec.es)
        j = np.searchsorted(mids, a, side="left")
        jc = np.clip(j, 0, mids.shape[0] - 1)
        tie = (j < mids.shape[0]) & (a == mids[jc])
        body = j + 1
        body = np.where(tie & (body % 2 == 1), body + 1, body)
        body = np.clip(body, 1, spec.maxpos_body)
        pat = np.where(sign, (-body) & spec.mask_n, body)
        return pat.astype(np.int64)

    def _mul(self, pa, pb, spec, plam: bool):
        va, na = self._decode_f64(pa, spec)
        vb, nb = self._decode_f64(pb, spec)
        sign = (va < 0) ^ (vb < 0)
        aa, ab = np.abs(va), np.abs(vb)
        if plam:
            # |x| = m * 2^e with m in [0.5, 1): fraction f = 2m - 1
            ma, ea = np.frexp(np.where(aa == 0, 1.0, aa))
            mb, eb = np.frexp(np.where(ab == 0, 1.0, ab))
            fs = (2.0 * ma - 1.0) + (2.0 * mb - 1.0)
            carry = (fs >= 1.0).astype(np.int64)
            scale = (ea - 1) + (eb - 1) + carry
            mag = np.ldexp(1.0 + fs - carry, scale)
        else:
            mag = aa * ab  # exact in f64 for n <= 16
        out = self._encode_f64(mag, sign, spec)
        out = np.where((aa == 0) | (ab == 0), 0, out)
        out = np.where(na | nb, spec.nar, out)
        return out.astype(np.int32)

    def exact_mul(self, pa, pb, spec):
        return self._mul(pa, pb, spec, plam=False)

    def plam_mul(self, pa, pb, spec):
        return self._mul(pa, pb, spec, plam=True)


# ---------------------------------------------------------------------------
# kernel wrappers: the CUDA kernels, or their plain versions
# ---------------------------------------------------------------------------


class KernelImpl(_DeviceImpl):
    """kernels/posit_codec.py: K3 (codec) and K4 (multipliers).

    ``use_kernel=True`` launches the CUDA kernels and needs a CUDA device
    (the oracle ``cuda``); ``use_kernel=False`` runs the wrappers' plain
    versions on the impl's device (``kernel_plain``).  The plain versions
    are the ``repro_torch.numerics`` functions that ``torch`` calls, so
    ``kernel_plain`` is the ``torch`` oracle behind the wrappers: it checks
    their dtype, shape and dispatch handling, not a second computation.
    (The reference's ``pallas_interp`` ran the Pallas kernel bodies, a
    separate code path.)  Comparisons of independent oracles leave it out
    (:attr:`repro_torch.conformance.fuzz.FuzzReport.independent`).
    """

    def __init__(self, use_kernel: bool, device: DeviceLike = "cpu"):
        super().__init__(device)
        if use_kernel and self.device.type != "cuda":
            raise ValueError("the cuda oracle needs a CUDA device")
        self.use_kernel = use_kernel
        self.name = "cuda" if use_kernel else "kernel_plain"

    def ops(self, spec):
        return _ops_for(spec)

    def encode(self, x, spec):
        out = pc.posit_encode(self._t(x, np.float32), spec, use_kernel=self.use_kernel)
        return self._patterns(out, spec)

    def decode(self, bits, spec):
        return self._floats(pc.posit_decode(self._t(bits, np.int32), spec,
                                         use_kernel=self.use_kernel))

    def quantize(self, x, spec):
        return self._floats(pc.posit_quantize(self._t(x, np.float32), spec,
                                           use_kernel=self.use_kernel))

    def exact_mul(self, pa, pb, spec):
        out = pc.exact_mul_elementwise(self._t(pa, np.int32), self._t(pb, np.int32), spec,
                                    use_kernel=self.use_kernel)
        return self._patterns(out, spec)

    def plam_mul(self, pa, pb, spec):
        out = pc.plam_mul_elementwise(self._t(pa, np.int32), self._t(pb, np.int32), spec,
                                   use_kernel=self.use_kernel)
        return self._patterns(out, spec)


# ---------------------------------------------------------------------------
# fault injection (meta-testing)
# ---------------------------------------------------------------------------


class FaultyImpl(Impl):
    """XOR ``1 << bit`` into ``op``'s output wherever ``trigger`` fires.

    ``trigger(*inputs)`` returns a boolean mask (or scalar) selecting
    the lanes to corrupt; the default corrupts every lane.  Used by the
    conformance tests to prove a single-bit fault in any one
    implementation is caught and shrunk by the fuzzer.
    """

    def __init__(self, base: Impl, op: str, bit: int = 0, trigger=None):
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}")
        self.base = base
        self.op = op
        self.bit = bit
        self.trigger = trigger
        self.name = f"{base.name}!{op}^{bit}"

    def ops(self, spec):
        return self.base.ops(spec)

    def _corrupt(self, out, inputs):
        mask = (
            np.ones(np.shape(out), bool)
            if self.trigger is None
            else np.broadcast_to(self.trigger(*inputs), np.shape(out))
        )
        out = np.asarray(out)
        if out.dtype.kind == "f":
            bits = out.astype(np.float32).view(np.uint32)
            bits = np.where(mask, bits ^ np.uint32(1 << self.bit), bits)
            return bits.view(np.float32)
        return np.where(mask, out ^ (1 << self.bit), out)

    def run(self, op, inputs, spec):
        out = self.base.run(op, inputs, spec)
        if op == self.op:
            out = self._corrupt(out, inputs)
        return out

    def __getattr__(self, item):
        if item in OPS:

            def call(*args):
                return self.run(item, args[:-1], args[-1])

            return call
        raise AttributeError(item)


def default_impls(spec: PositSpec, device: DeviceLike = None):
    """The oracle matrix for ``spec``: name -> Impl.

    The device is resolved by :func:`repro_torch.device.resolve_device`:
    CUDA unless the caller names another, and an error without a card.
    ``cuda`` (the CUDA kernels) is registered exactly when the device is
    a CUDA device; the vectorized impls run on that device.
    """
    dev = resolve_device(device)
    impls = {
        "golden": GoldenImpl(),
        "torch": TorchImpl(device=dev),
        "torch_logfix": TorchImpl(variant="logfix", device=dev),
        "table": TableImpl(device=dev),
        "kernel_plain": KernelImpl(use_kernel=False, device=dev),
    }
    if dev.type == "cuda":
        impls["cuda"] = KernelImpl(use_kernel=True, device=dev)
    return impls
