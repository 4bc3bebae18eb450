"""Port numerics (repro_torch.numerics) against the JAX reference, bit for bit.

Inputs are made with numpy and fed to both packages; JAX stays on the CPU.
"""
import json
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import numerics as J  # noqa: E402
from repro.conformance.vectors import _hash_floats, _vector_inputs  # noqa: E402
from repro_torch import numerics as T  # noqa: E402

VECTOR_DIR = pathlib.Path(__file__).resolve().parent / "vectors"
SMALL_SPECS = [(6, 0), (8, 0), (8, 1), (10, 1)]


def _f32_sweep(seed: int, n: int = 50_000) -> np.ndarray:
    """Random magnitudes over the whole f32 exponent range plus the edge
    cases: signed zeros, subnormals, infinities, NaN, values past maxpos."""
    rng = np.random.default_rng(seed)
    expo = rng.integers(-149, 128, n).astype(np.float64)
    with np.errstate(over="ignore"):  # magnitudes past f32 become +-inf
        x = (rng.standard_normal(n) * np.exp2(expo)).astype(np.float32)
    edges = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1e-45,
                        -1e-45, 3e38, -3e38, 2.0 ** 60, -(2.0 ** 60), 1.0, -1.0])
    return np.concatenate([x, edges])


def _f32_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("n,es", SMALL_SPECS)
def test_plam_product_all_pairs(n, es):
    """Every (a, b) pattern pair: the port's PLAM product == the reference's."""
    pats = np.arange(1 << n, dtype=np.int32)
    pa, pb = np.repeat(pats, 1 << n), np.tile(pats, 1 << n)
    want = J.plam_product_f32(jnp.asarray(pa), jnp.asarray(pb), J.PositSpec(n, es))
    got = T.plam_product_f32(torch.from_numpy(pa), torch.from_numpy(pb), T.PositSpec(n, es))
    assert np.array_equal(_f32_bits(want), got.numpy().view(np.uint32))


@pytest.mark.parametrize("n,es", SMALL_SPECS + [(16, 1), (12, 2)])
def test_decode_all_patterns(n, es):
    pats = np.arange(1 << n, dtype=np.int32)
    want = J.decode(jnp.asarray(pats), J.PositSpec(n, es))
    got = T.decode(torch.from_numpy(pats), T.PositSpec(n, es))
    assert np.array_equal(_f32_bits(want), got.numpy().view(np.uint32))


@pytest.mark.parametrize("n,es", SMALL_SPECS + [(16, 1), (24, 1)])
def test_encode_and_quantize_sweep(n, es):
    x = _f32_sweep(seed=n * 10 + es)
    js, ts = J.PositSpec(n, es), T.PositSpec(n, es)
    want = np.asarray(J.encode(jnp.asarray(x), js))
    got = T.encode(torch.from_numpy(x), ts).numpy()
    assert np.array_equal(want, got)
    want_q = J.quantize(jnp.asarray(x), js)
    got_q = T.quantize(torch.from_numpy(x), ts)
    assert np.array_equal(_f32_bits(want_q), got_q.numpy().view(np.uint32))


def test_encode_fields_per_lane_fraction_width():
    """encode_fields with a per-element fbits tensor (the exact multiplier's
    use) matches the reference."""
    rng = np.random.default_rng(4)
    m = 4096
    sign = rng.integers(0, 2, m).astype(np.int32)
    scale = rng.integers(-30, 31, m).astype(np.int32)
    fbits = rng.integers(1, 27, m).astype(np.int32)
    frac = (rng.integers(0, 1 << 30, m) & ((1 << fbits) - 1)).astype(np.uint32)
    want = J.encode_fields(jnp.asarray(sign), jnp.asarray(scale), jnp.asarray(frac),
                           jnp.asarray(fbits), J.PositSpec(16, 1))
    got = T.encode_fields(torch.from_numpy(sign), torch.from_numpy(scale),
                          torch.from_numpy(frac.astype(np.int64)), torch.from_numpy(fbits),
                          T.PositSpec(16, 1))
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("n,es", [(8, 0), (16, 1)])
def test_encode_subnormal_regression(n, es):
    """An f32-subnormal input encodes to +-minpos, never to zero (the DAZ
    bug the reference's fuzzer caught)."""
    x = np.float32([9.99994610111476e-41, -9.99994610111476e-41])
    spec = T.PositSpec(n, es)
    got = T.encode(torch.from_numpy(x), spec).numpy().astype(np.int64) & spec.mask_n
    assert got.tolist() == [1, spec.mask_n]


@pytest.mark.parametrize(
    "path", sorted(VECTOR_DIR.glob("decode_*.json")), ids=lambda p: p.stem)
def test_committed_decode_vectors(path):
    """The port's decode hashes to the committed vector digest."""
    doc = json.loads(path.read_text())
    n, es = doc["spec"]
    (pats,) = _vector_inputs("decode", J.PositSpec(n, es), doc["kind"], doc["seed"])
    got = T.decode(torch.from_numpy(np.asarray(pats, np.int32)), T.PositSpec(n, es))
    assert _hash_floats(got.numpy()) == doc["sha256"]
    for pat, want_bits in doc["samples"]:
        one = T.decode(torch.tensor([pat], dtype=torch.int32), T.PositSpec(n, es))
        assert int(one.numpy().view(np.uint32)[0]) == want_bits


def test_pack16_round_trip_matches_reference():
    pats = np.arange(1 << 16, dtype=np.int32)
    want = np.asarray(J.pack16(jnp.asarray(pats)))
    got = T.pack16(torch.from_numpy(pats))
    assert got.dtype == torch.int16
    assert np.array_equal(want, got.numpy())
    assert np.array_equal(T.unpack16(got).numpy(), pats)


def test_quantize_straight_through_gradient():
    x = torch.tensor([0.3, -1.7, 5.0e-3], requires_grad=True)
    y = T.quantize(x, T.P16)
    y.backward(torch.tensor([1.0, 2.0, 3.0]))
    assert torch.equal(x.grad, torch.tensor([1.0, 2.0, 3.0]))
    assert torch.equal(y.detach(), T.decode(T.encode(x.detach(), T.P16), T.P16))


def test_spec_fields_match_reference():
    for n, es in SMALL_SPECS + [(16, 1), (32, 2)]:
        js, ts = J.PositSpec(n, es), T.PositSpec(n, es)
        for field in ("useed_exp", "fbmax", "mask_n", "nar", "maxpos_body", "max_scale"):
            assert getattr(js, field) == getattr(ts, field), (n, es, field)


# -- the multipliers, the table codec and the golden copy ----------------------

MUL_SPECS = [(8, 0), (8, 1), (16, 1), (16, 2)]


def _mul_operands(n: int):
    """All pattern pairs for n <= 8, else 4096 seeded pairs (the reference's
    sampled-vector size)."""
    if n <= 8:
        pats = np.arange(1 << n, dtype=np.int32)
        return np.repeat(pats, 1 << n), np.tile(pats, 1 << n)
    rng = np.random.default_rng(np.random.SeedSequence([n, 0x4D]))
    return (rng.integers(0, 1 << n, 4096).astype(np.int32),
            rng.integers(0, 1 << n, 4096).astype(np.int32))


@pytest.mark.parametrize("fn", ["plam_mul", "plam_mul_logfix", "exact_mul",
                                "plam_relative_error"])
@pytest.mark.parametrize("n,es", MUL_SPECS)
def test_multipliers_bit_identical(fn, n, es):
    pa, pb = _mul_operands(n)
    want = np.asarray(getattr(J, fn)(jnp.asarray(pa), jnp.asarray(pb), J.PositSpec(n, es)))
    got = getattr(T, fn)(torch.from_numpy(pa), torch.from_numpy(pb), T.PositSpec(n, es))
    assert got.dtype == (torch.float32 if fn == "plam_relative_error" else torch.int32)
    assert np.array_equal(want.view(np.uint32), got.numpy().view(np.uint32))


def test_multipliers_refuse_what_the_reference_asserts():
    a = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="n <= 16"):
        T.exact_mul(a, a, T.PositSpec(24, 1))
    with pytest.raises(ValueError, match="logfix"):
        T.plam_mul_logfix(a, a, T.PositSpec(32, 2))


def test_mitchell_mul_f32_bit_identical():
    rng = np.random.default_rng(21)
    a = rng.standard_normal(50_000).astype(np.float32)
    b = (rng.standard_normal(50_000) * 10.0 ** rng.integers(-5, 5, 50_000)).astype(np.float32)
    a[:100] = 0.0
    b[50:150] = -0.0
    want = J.mitchell_mul_f32(jnp.asarray(a), jnp.asarray(b))
    got = T.mitchell_mul_f32(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(_f32_bits(want), got.numpy().view(np.uint32))


@pytest.mark.parametrize("n,es", SMALL_SPECS + [(16, 1), (16, 2)])
def test_table_codec_bit_identical(n, es):
    """decode_table over every pattern and encode_table over the fuzzer's
    floats (with its subnormal and overflow specials) and a wide sweep."""
    from repro.conformance.fuzz import sample_floats

    js, ts = J.PositSpec(n, es), T.PositSpec(n, es)
    want_v, want_m = J.tables(n, es)
    got_v, got_m = T.tables(n, es)
    assert np.array_equal(want_v, got_v) and np.array_equal(want_m, got_m)
    pats = np.arange(1 << n, dtype=np.int32)
    want = J.decode_table(jnp.asarray(pats), js)
    got = T.decode_table(torch.from_numpy(pats), ts)
    assert np.array_equal(_f32_bits(want), got.numpy().view(np.uint32))
    x = np.concatenate([sample_floats(np.random.default_rng(n + es), 4096),
                        _f32_sweep(seed=n + 100 * es, n=20_000)])
    want_e = np.asarray(J.encode_table(jnp.asarray(x), js))
    got_e = T.encode_table(torch.from_numpy(x), ts).numpy()
    assert np.array_equal(want_e, got_e)
    # the table codec agrees with the bit-field codec, as in the reference
    assert np.array_equal(got_e, T.encode(torch.from_numpy(x), ts).numpy())


@pytest.mark.parametrize("n,es", SMALL_SPECS + [(16, 1)])
def test_golden_copy_matches_reference(n, es):
    from repro.numerics import golden as jg
    from repro_torch.numerics import golden as tg

    assert tg.all_values(n, es) == jg.all_values(n, es)
    assert tg.thresholds(n, es) == jg.thresholds(n, es)
    rng = np.random.default_rng(n * 7 + es)
    pats = rng.integers(0, 1 << n, 300).tolist() + [0, 1 << (n - 1), 1, (1 << n) - 1]
    for p in pats:
        got, want = tg.decode_py(p, n, es), jg.decode_py(p, n, es)
        assert got == want or (got != got and want != want)
        if p not in (0, 1 << (n - 1)):
            assert tg.decode_fields_py(p, n, es) == jg.decode_fields_py(p, n, es)
    for x in [0.0, -0.0, float("inf"), float("nan"), 1e-40, -3e38,
              *rng.standard_normal(200).tolist()]:
        assert tg.encode_py(x, n, es) == jg.encode_py(x, n, es)
    for pa, pb in zip(pats, reversed(pats)):
        assert tg.plam_mul_py(pa, pb, n, es) == jg.plam_mul_py(pa, pb, n, es)
        assert tg.exact_mul_py(pa, pb, n, es) == jg.exact_mul_py(pa, pb, n, es)
