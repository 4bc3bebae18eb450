"""Port kernels' plain versions against the JAX reference, and the CUDA
kernels against their plain versions on the card (``cuda`` marker).

On the CPU every wrapper takes its plain version because its tensors lie
on the CPU; the launch counters must stay 0 here.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as j_decode_attention,
)
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention_ref as j_decode_attention_ref,
)
from repro.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention_kernel as j_paged_kernel,
)
from repro.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention_ref as j_paged_ref,
)
from repro.kernels.ref import plam_matmul_seqref as j_seqref  # noqa: E402
from repro.numerics import PositSpec as JSpec  # noqa: E402
from repro_torch.kernels import _lib, ops  # noqa: E402
from repro_torch.kernels import posit_codec as pc  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_kernel,
    decode_attention_ref,
    gather_pages,
    paged_decode_attention,
    paged_decode_attention_kernel,
    paged_decode_attention_ref,
    card_sms,
    split_plan,
    SplitPlan,
)
from repro_torch.numerics import P16, PositSpec, pack16  # noqa: E402

# the reference conformance suite's ragged shapes (tests/test_conformance.py)
RAGGED_SHAPES = [(4, 5, 3), (1, 7, 1), (3, 130, 9), (9, 257, 5), (2, 1, 2), (17, 64, 33)]
SHAPE_IDS = ["x".join(map(str, s)) for s in RAGGED_SHAPES]
# (M, K, N) at the edges of the CUDA kernel's decode path (M <= 16):
# k-tiles of 2048/BN rows and a 4-stage ring (K = BK*S +- 1, K = 4097),
# strips of 8-16 columns, vector (N % 8 == 0) or scalar loads on a ragged
# k-tail, N = 8j + 1, and the M <= 4 / M <= 16 branch edges (M = 5, 16).
# chip_smoke.py checks the kernel on the card at copies of both lists.
EDGE_SHAPES = [(4, 1023, 8), (4, 1025, 9), (3, 4097, 16), (1, 4097, 12), (5, 513, 24),
               (16, 511, 17), (2, 300, 40)]
K1_SHAPES = RAGGED_SHAPES + EDGE_SHAPES
K1_IDS = ["x".join(map(str, s)) for s in K1_SHAPES]
# (M, K, N) at the edges of the kernel's prefill path (M > 16): 64-row
# blocks, 32-deep k-tiles in a 3-stage ring with a ragged tail, scalar A
# (K % 8 != 0) and B (N % 8 != 0) loads, and N at each strip width's wave
# edge on 132 SMs.  Odd cases plant zero and NaR patterns in a middle
# k-tile (_prefill_operands).  chip_smoke.py checks the kernel at a copy;
# here the plain versions run at _cpu_size of each shape.
PREFILL_EDGE_SHAPES = [(17, 31, 16), (63, 33, 17), (64, 4095, 33), (65, 4097, 511),
                       (128, 4096, 4100), (256, 1000, 512), (17, 64, 16), (64, 96, 4104),
                       (48, 4096, 2112), (48, 4096, 2113), (64, 4096, 4224), (64, 2048, 4225),
                       (48, 1024, 8448), (33, 1024, 8449)]
PREFILL_IDS = ["x".join(map(str, s)) for s in PREFILL_EDGE_SHAPES]


def test_chip_smoke_checks_k1_at_these_shapes():
    """chip_smoke.py (which runs without the tests) keeps copies of
    RAGGED_SHAPES, EDGE_SHAPES and PREFILL_EDGE_SHAPES; they must not
    drift from these."""
    import ast
    import pathlib

    tree = ast.parse((pathlib.Path(__file__).parents[1] / "chip_smoke.py").read_text())
    names = ("RAGGED_SHAPES", "K1_EDGE_SHAPES", "K1_PREFILL_EDGE_SHAPES")
    lists = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets if isinstance(t, ast.Name)
             and t.id in names}
    assert lists == {"RAGGED_SHAPES": RAGGED_SHAPES, "K1_EDGE_SHAPES": EDGE_SHAPES,
                     "K1_PREFILL_EDGE_SHAPES": PREFILL_EDGE_SHAPES}


def test_chip_smoke_checks_k3_at_these_specs():
    """chip_smoke.py keeps copies of TABLE_SPECS, TABLE_PATH_SPECS and
    WEIGHT_SHAPES."""
    import ast
    import pathlib

    tree = ast.parse((pathlib.Path(__file__).parents[1] / "chip_smoke.py").read_text())
    names = ("K3_TABLE_SPECS", "K3_PATH_SPECS", "K3_WEIGHT_SHAPES")
    lists = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets if isinstance(t, ast.Name)
             and t.id in names}
    assert lists == {"K3_TABLE_SPECS": TABLE_SPECS, "K3_PATH_SPECS": TABLE_PATH_SPECS,
                     "K3_WEIGHT_SHAPES": WEIGHT_SHAPES}


def _ragged_operands(shape):
    """The reference suite's operands: random patterns with NaR lanes in A
    and zero lanes in B."""
    m, k, n = shape
    rng = np.random.default_rng(hash(shape) & 0xFFFF)
    a = rng.integers(0, 1 << 16, (m, k)).astype(np.int32)
    b = rng.integers(0, 1 << 16, (k, n)).astype(np.int32)
    a.flat[:: max(1, a.size // 7)] = P16.nar
    b.flat[:: max(1, b.size // 5)] = 0
    return a, b


def _cpu_size(shape):
    """A prefill edge shape cut to the CPU: K above 300 to 256 + K % 32 (the
    same ragged tail and K % 8), N above 128 to 64 + N % 64 (the same N % 8)."""
    m, k, n = shape
    return m, k if k <= 300 else 256 + k % 32, n if n <= 128 else 64 + n % 64


def _prefill_operands(shape, case):
    """chip_smoke.py's prefill-edge operands (case is the shape's index):
    int32 A and B patterns with no zero or NaR, and f32 activations; odd
    cases plant zero and NaR patterns (zero, inf and NaN activations) in a
    middle k-tile of A and of B."""
    m, k, n = shape
    rng = np.random.default_rng(1000 + case)
    a = rng.integers(1, 1 << 16, (m, k)).astype(np.int32)
    b = rng.integers(1, 1 << 16, (k, n)).astype(np.int32)
    a[a == P16.nar] = 1
    b[b == P16.nar] = 1
    x = rng.standard_normal((m, k)).astype(np.float32)
    if case % 2:
        t = (k // 32) // 2 * 32  # the first k of a middle tile
        k1, k2, k3 = (min(k - 1, t + d) for d in (1, 2, 5))
        a[m // 2, k3], a[m - 1, k1] = P16.nar, 0
        b[k3, n // 2], b[k2, n - 1] = 0, P16.nar
        x[m // 2, k3], x[m - 1, k1], x[0, k2] = 0.0, np.inf, np.nan
    return a, b, x


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    """Nothing in this file launches a kernel unless a card is present."""
    _lib.reset_launches()
    yield
    if not torch.cuda.is_available():
        assert all(v == 0 for v in _lib.launches.values()), _lib.launches


@pytest.mark.parametrize("shape", K1_SHAPES, ids=K1_IDS)
def test_plam_matmul_plain_bit_identical_to_reference_seqref(shape):
    a, b = _ragged_operands(shape)
    want = j_seqref(jnp.asarray(a), jnp.asarray(b), JSpec(16, 1))
    got = ops.plam_matmul_bits(torch.from_numpy(a), torch.from_numpy(b), P16)
    assert np.array_equal(_bits(want), got.numpy().view(np.uint32))
    # int16 patterns (prequantized storage) give the same bits
    got16 = ops.plam_matmul_bits(torch.from_numpy(a), pack16(torch.from_numpy(b)), P16)
    assert torch.equal(got16.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("shape", K1_SHAPES, ids=K1_IDS)
def test_plam_dense_plain_bit_identical_to_jax_kernel(shape):
    """plam_dense (encode activations, PLAM matmul) == the JAX Pallas path
    run in interpret mode, bit for bit."""
    m, k, n = shape
    _, b = _ragged_operands(shape)
    x = np.random.default_rng(k).standard_normal((m, k)).astype(np.float32)
    want = jops.plam_dense(jnp.asarray(x), jnp.asarray(b), JSpec(16, 1), interpret=True)
    got = ops.plam_dense(torch.from_numpy(x), torch.from_numpy(b), P16)
    assert np.array_equal(_bits(want), got.numpy().view(np.uint32))


@pytest.mark.parametrize("case", range(len(PREFILL_EDGE_SHAPES)), ids=PREFILL_IDS)
def test_plam_matmul_plain_bit_identical_at_prefill_edges(case):
    """The plain plam_matmul (int32 and int16 B) and plam_dense (f32 and
    bf16 activations) at the prefill path's edge shapes, cut to the CPU,
    planted zero and NaR tiles included, against the JAX plam_matmul_seqref
    of the JAX encode, bit for bit."""
    from repro.numerics import encode as j_encode

    a, b, x = _prefill_operands(_cpu_size(PREFILL_EDGE_SHAPES[case]), case)
    spec = JSpec(16, 1)
    bt = torch.from_numpy(b)
    want = _bits(j_seqref(jnp.asarray(a), jnp.asarray(b), spec))
    for bb in (bt, pack16(bt)):
        got = ops.plam_matmul_bits(torch.from_numpy(a), bb, P16)
        assert np.array_equal(got.numpy().view(np.uint32), want)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    for xt, xj in [(torch.from_numpy(x), x), (xb, xb.to(torch.float32).numpy())]:
        want = _bits(j_seqref(j_encode(jnp.asarray(xj), spec), jnp.asarray(b), spec))
        for bb in (bt, pack16(bt)):
            got = ops.plam_dense(xt, bb, P16)
            assert np.array_equal(got.numpy().view(np.uint32), want)


def test_posit_codec_plain_matches_jax_kernels():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((33, 70)) * 10.0 ** rng.integers(-6, 6, (33, 70))).astype(
        np.float32)
    want_e = jops.posit_encode(jnp.asarray(x), JSpec(16, 1), interpret=True)
    got_e = ops.posit_encode(torch.from_numpy(x), P16)
    assert np.array_equal(np.asarray(want_e), got_e.numpy())
    got_e16 = ops.posit_encode(torch.from_numpy(x), P16, out_dtype=torch.int16)
    assert torch.equal(got_e16, pack16(got_e))
    want_d = jops.posit_decode(jnp.asarray(np.asarray(want_e)), JSpec(16, 1), interpret=True)
    assert np.array_equal(_bits(want_d), ops.posit_decode(got_e, P16).numpy().view(np.uint32))
    assert torch.equal(ops.posit_decode(got_e16, P16), ops.posit_decode(got_e, P16))
    want_q = jops.posit_quantize(jnp.asarray(x), JSpec(16, 1), interpret=True)
    got_q = ops.posit_quantize(torch.from_numpy(x), P16)
    assert np.array_equal(_bits(want_q), got_q.numpy().view(np.uint32))
    # bf16 activations encode as their exact f32 values
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(ops.posit_encode(xb, P16), ops.posit_encode(xb.float(), P16))


@pytest.mark.parametrize("what", ["encode int32", "encode int16", "quantize"])
def test_plain_codec_by_slices_equals_one_call(monkeypatch, what):
    """The plain encode and quantize take at most PLAIN_LANES lanes at a
    time: over a ragged last slice they give the one call's bits."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((9, 13)) * 10.0 ** rng.integers(-4, 4, (9, 13)))
                         .astype(np.float32))
    fn = {"encode int32": lambda t: pc.encode_plain(t, P16, torch.int32),
          "encode int16": lambda t: pc.encode_plain(t, P16, torch.int16),
          "quantize": lambda t: pc.quantize_plain(t, P16)}[what]
    whole = fn(x)
    monkeypatch.setattr(ref, "PLAIN_LANES", 10)
    sliced = fn(x)
    assert sliced.shape == whole.shape and sliced.dtype == whole.dtype
    assert torch.equal(sliced.view(torch.int32) if what == "quantize" else sliced,
                       whole.view(torch.int32) if what == "quantize" else whole)


# the specs at which the encode's table path is checked (n <= 16)
TABLE_SPECS = [(16, 1), (16, 2), (16, 0), (12, 1), (10, 1), (8, 1), (8, 0), (6, 0)]
TABLE_IDS = [f"p{n}es{es}" for n, es in TABLE_SPECS]
# the table path at Posit<16,1> and three other specs on the card
TABLE_PATH_SPECS = [(16, 1), (16, 2), (10, 1), (8, 0)]
# the serve path's weight shapes at which the card's encode is checked:
# wk/wv, wg/wu (the grid capped at one block an SM) and the unembed
WEIGHT_SHAPES = [(4096, 512), (4096, 11008), (4096, 64000)]


def _all_bf16() -> torch.Tensor:
    """The 65,536 bf16 patterns, in pattern order."""
    return torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)


def _tiled_bf16(n: int, seed: int = 0) -> torch.Tensor:
    """n lanes of the 65,536 bf16 patterns tiled and shuffled."""
    pats = np.tile(np.arange(1 << 16, dtype=np.uint16), n // (1 << 16) + 1)[:n]
    np.random.default_rng(seed).shuffle(pats)
    return torch.from_numpy(pats.view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("n,es", TABLE_SPECS, ids=TABLE_IDS)
def test_bf16_table_plain_with_sign_rule_matches_jax_encode(n, es):
    """The table of the 32,768 non-negative bf16 patterns, with the sign
    rule p = sign ? (0 - t) & mask_n : t, gives the JAX encode of every
    one of the 65,536 bf16 patterns (+-0, subnormals, inf and NaN
    included)."""
    from repro.numerics import encode as j_encode

    spec = PositSpec(n, es)
    table = pc.bf16_table_plain(spec).numpy().view(np.uint16).astype(np.uint32)
    assert table.shape == (pc.TABLE_ENTRIES,)
    bits = np.arange(1 << 16, dtype=np.uint32)
    t = table[bits & 0x7FFF]
    got = np.where(bits & 0x8000, (np.uint32(0) - t) & np.uint32(spec.mask_n), t)
    want = np.asarray(j_encode(jnp.asarray((bits << 16).view(np.float32)), JSpec(n, es)))
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))


def _table_lookup(x, table, spec, out_dtype):
    """csrc/posit_codec.cu's table lookup, plain: a bf16 lane's pattern
    is its magnitude's entry, negated and masked to n bits where its sign
    bit is set; int16 keeps the low 16 bits, int32 zero-extends them."""
    bits = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    t = table.to(torch.int32)[(bits & 0x7FFF).long()] & 0xFFFF
    p = torch.where(bits >= 0x8000, (0 - t) & spec.mask_n, t)
    return pack16(p) if out_dtype == torch.int16 else p


@pytest.mark.parametrize("n,es", TABLE_SPECS, ids=TABLE_IDS)
def test_table_lookup_mirror_equals_encode_plain(n, es):
    """The kernel's lookup, plain (magnitude index, negate and mask, int16
    packing, int32 zero-extension), equals encode_plain on all 65,536 bf16
    patterns at int16 and int32 output."""
    spec = PositSpec(n, es)
    x, table = _all_bf16(), pc.bf16_table_plain(spec)
    for od in (torch.int16, torch.int32):
        got = _table_lookup(x, table, spec, od)
        assert got.dtype == od and torch.equal(got, pc.encode_plain(x, spec, od))
    wide = _table_lookup(x, table, spec, torch.int32)
    assert int(wide.min()) >= 0 and int(wide.max()) <= spec.mask_n  # zero-extended


def test_encode_path_rule():
    """bf16 with n <= 16 takes the table from TABLE_MIN_NUMEL lanes on;
    f32, n > 16 and fewer lanes compute."""
    th, bf = pc.TABLE_MIN_NUMEL, torch.bfloat16
    for n, es in TABLE_SPECS:
        spec = PositSpec(n, es)
        assert pc.encode_path(bf, th - 1, spec) == "computed"
        assert pc.encode_path(bf, th, spec) == "table"
        assert pc.encode_path(bf, th + 1, spec) == "table"
    for numel in (th - 1, th, th + 1):
        assert pc.encode_path(bf, numel, PositSpec(17, 1)) == "computed"
        assert pc.encode_path(torch.float32, numel, P16) == "computed"
    assert pc.encode_path(bf, 45_088_768, P16) == "table"  # a [4096, 11008] weight
    assert pc.encode_path(bf, 64 * 11008, P16) == "computed"  # a prefill activation


def test_posit_encode_views_at_element_offsets():
    """A view at an element offset (the kernel's head lanes) is legal
    input and encodes as the same lanes of the whole."""
    x = _tiled_bf16(1001)
    for od in (torch.int16, torch.int32):
        whole = ops.posit_encode(x, P16, out_dtype=od)
        for off in (1, 2, 4):
            got = ops.posit_encode(x[off:], P16, out_dtype=od)
            assert got.dtype == od and torch.equal(got, whole[off:])


def test_nmatmul_plam_sim_bf16_operands_same_bits_as_f32_and_int32(monkeypatch):
    """plam_sim on bf16 operands encodes the weight to int16 patterns
    from its bf16 bits, and gives the bits of the earlier path (both
    operands cast to f32, the weight encoded to int32 patterns)."""
    from repro_torch.core.modes import PLAM16, nmatmul

    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 70)).astype(np.float32)
    w = (rng.standard_normal((70, 9)) * 0.1).astype(np.float32)
    x[0, :6] = [0.0, -0.0, 1e-30, -3e20, 2.0 ** -20, 4097.0]  # outside the exact range
    w[:4, 0] = [0.0, 1e-38, -5e15, 2.0 ** 14]
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    before = ops.plam_dense(xb.float(), ops.posit_encode(wb.float(), P16), P16)
    seen, encode = [], ops.posit_encode

    def spy(t, *args, **kw):
        seen.append((t.dtype, kw.get("out_dtype")))
        return encode(t, *args, **kw)

    monkeypatch.setattr(ops, "posit_encode", spy)
    got = nmatmul(xb, wb, PLAM16, out_dtype=torch.float32)
    assert seen == [(torch.bfloat16, torch.int16)]
    assert torch.equal(got.view(torch.int32), before.view(torch.int32))
    assert torch.equal(nmatmul(xb, wb, PLAM16), before.to(torch.bfloat16))


def _paged_case(seed=0, dtype=np.float32, lengths=(1, 6, 11), max_blk=None, h=4, kv=2,
                hd=16, bs=4):
    """Sequences with ragged lengths over a permuted pool whose block 0 is
    scratch; block tables padded with the scratch block up to max_blk."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    lengths = np.array(lengths, np.int32)
    need = [max(1, -(-int(n) // bs)) for n in lengths]
    nb = 1 + sum(need) + 2
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, max_blk or max(need)), np.int32)
    pos = 0
    for i, c in enumerate(need):
        tables[i, :c] = perm[pos:pos + c]
        pos += c
    q = rng.standard_normal((b, h, hd)).astype(dtype)
    kp = rng.standard_normal((nb, bs, kv, hd)).astype(dtype)
    vp = rng.standard_normal((nb, bs, kv, hd)).astype(dtype)
    return q, kp, vp, tables, lengths


def test_paged_attention_plain_matches_reference_ref_and_kernel():
    """f32 pools: the port's plain version is allclose (1e-6) to the
    reference's gather oracle and to its Pallas kernel in interpret mode."""
    q, kp, vp, tables, lengths = _paged_case()
    got = paged_decode_attention(*map(torch.from_numpy, (q, kp, vp, tables, lengths)))
    want_ref = j_paged_ref(*map(jnp.asarray, (q, kp, vp, tables, lengths)))
    want_kernel = j_paged_kernel(*map(jnp.asarray, (q, kp, vp, tables, lengths)),
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), rtol=1e-6, atol=1e-6)


# length 0 (every key masked: uniform weights over all max_blk * bs keys,
# padding blocks included) and the full table (max_blk * bs = 12 keys)
@pytest.mark.parametrize("lengths", [(0, 6, 11), (0, 0, 0), (12, 12, 12), (0, 12, 5)],
                         ids=["len0", "all-len0", "full", "len0-full-mixed"])
def test_paged_attention_plain_matches_reference_at_length_edges(lengths):
    q, kp, vp, tables, lens = _paged_case(seed=5, lengths=lengths, max_blk=3)
    got = paged_decode_attention(*map(torch.from_numpy, (q, kp, vp, tables, lens)))
    want_ref = j_paged_ref(*map(jnp.asarray, (q, kp, vp, tables, lens)))
    want_kernel = j_paged_kernel(*map(jnp.asarray, (q, kp, vp, tables, lens)), interpret=True)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), rtol=1e-6, atol=1e-6)
    if 0 in lengths:  # the mean of V over every key the table names
        i = lengths.index(0)
        v_all = gather_pages(torch.from_numpy(vp), torch.from_numpy(tables))[i]  # [S, kv, hd]
        mean = v_all.mean(0).repeat_interleave(2, dim=0)  # q heads 2g, 2g+1 share kv head g
        torch.testing.assert_close(got[i], mean, rtol=1e-5, atol=1e-6)


def test_gather_pages_layout():
    q, kp, vp, tables, lengths = _paged_case(seed=2)
    got = gather_pages(torch.from_numpy(kp), torch.from_numpy(tables))
    from repro.kernels.decode_attention import gather_pages as j_gather

    assert np.array_equal(got.numpy(), np.asarray(j_gather(jnp.asarray(kp),
                                                           jnp.asarray(tables))))


def test_wrappers_refuse_cpu_tensors_for_the_kernel():
    a = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.plam_matmul_bits(a, a.T.contiguous(), P16, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.posit_encode(torch.zeros(4), P16, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_kernel(*map(torch.from_numpy, _paged_case()))


def test_plam_matmul_rejects_bad_operands():
    a = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="shapes"):
        ops.plam_matmul_bits(a, torch.zeros((4, 2), dtype=torch.int32), P16)
    with pytest.raises(ValueError, match="int16"):
        ops.plam_matmul_bits(a, torch.zeros((3, 2), dtype=torch.int16), PositSpec(24, 1))


# -- K4: the element-wise multipliers ------------------------------------------

def _k4_operands(case):
    """Posit<8,1> all pairs, or 1000 seeded lanes at Posit<16,1> (a length
    no tile divides)."""
    if case == "p8es1_exhaustive":
        pats = np.arange(256, dtype=np.int32)
        return JSpec(8, 1), PositSpec(8, 1), np.repeat(pats, 256), np.tile(pats, 256)
    rng = np.random.default_rng(12)
    pa, pb = (rng.integers(0, 1 << 16, 1000).astype(np.int32) for _ in range(2))
    pa[::37], pb[::41] = 0, P16.nar
    return JSpec(16, 1), P16, pa, pb


@pytest.mark.parametrize("fn", ["plam_mul_elementwise", "exact_mul_elementwise"])
@pytest.mark.parametrize("case", ["p8es1_exhaustive", "p16es1_ragged1000"])
def test_posit_mul_plain_bit_identical_to_jax_kernel(fn, case):
    """K4's plain path == the Pallas kernel in interpret mode, bit for bit."""
    jspec, spec, pa, pb = _k4_operands(case)
    want = getattr(jops, fn)(jnp.asarray(pa), jnp.asarray(pb), jspec, interpret=True)
    got = getattr(ops, fn)(torch.from_numpy(pa), torch.from_numpy(pb), spec)
    assert got.dtype == torch.int32 and got.shape == pa.shape
    assert np.array_equal(np.asarray(want), got.numpy())


def test_posit_mul_wrappers_check_their_operands():
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="shapes"):
        ops.plam_mul_elementwise(a, a[:4], P16)
    with pytest.raises(ValueError, match="n <= 16"):
        ops.exact_mul_elementwise(a, a, PositSpec(24, 1))
    with pytest.raises(ValueError, match="CUDA"):
        ops.plam_mul_elementwise(a, a, P16, use_kernel=True)
    # every spec the plain version takes, up to 32 bits
    assert ops.plam_mul_elementwise(a, a, PositSpec(32, 2)).dtype == torch.int32


# -- K5: contiguous-cache decode attention --------------------------------------

# the reference's shapes (tests/test_resilience.py): b, s, h, kv, hd, blk
K5_SHAPES = [(2, 64, 8, 4, 16, 16), (1, 96, 4, 2, 32, 32)]


def _k5_case(shape, seed=0):
    b, s, h, kvh, hd, _ = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    lens = rng.integers(1, s + 1, b).astype(np.int32)
    return q, k, v, lens


@pytest.mark.parametrize("shape", K5_SHAPES, ids=["x".join(map(str, s)) for s in K5_SHAPES])
def test_decode_attention_plain_matches_jax_kernel_and_ref(shape):
    q, k, v, lens = _k5_case(shape)
    got = decode_attention(*map(torch.from_numpy, (q, k, v, lens)), blk=shape[-1])
    want_kernel = j_decode_attention(*map(jnp.asarray, (q, k, v, lens)), blk=shape[-1],
                                     interpret=True)
    want_ref = j_decode_attention_ref(*map(jnp.asarray, (q, k, v, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=2e-5, atol=2e-5)


# length 0 (uniform over all S keys) and the full cache; S = 64 is a whole
# number of the reference kernel's 16-key blocks, so it pads nothing
@pytest.mark.parametrize("lens", [(0, 64), (64, 0), (0, 0)], ids=["len0-full", "full-len0",
                                                                 "all-len0"])
def test_decode_attention_plain_matches_jax_at_length_edges(lens):
    q, k, v, _ = _k5_case((2, 64, 8, 4, 16, 16), seed=2)
    lens = np.array(lens, np.int32)
    got = decode_attention(*map(torch.from_numpy, (q, k, v, lens)))
    want_kernel = j_decode_attention(*map(jnp.asarray, (q, k, v, lens)), blk=16,
                                     interpret=True)
    want_ref = j_decode_attention_ref(*map(jnp.asarray, (q, k, v, lens)))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), rtol=2e-5, atol=2e-5)


# the SMs of an H100 SXM, the card the split plan was sized on
H100_SMS = 132


@pytest.mark.parametrize("capacity", [1, 15, 16, 80, 128, 256, 257, 704, 4096],
                         ids=lambda c: f"cap{c}")
@pytest.mark.parametrize("batch,kv,split_keys", [(4, 4, None), (13, 4, None), (1, 1, None),
                                                 (64, 8, None), (2, 4, 16), (1, 2, 32),
                                                 (3, 1, 1)])
def test_split_plan_covers_each_live_key_once(capacity, batch, kv, split_keys):
    """The kernels' splits (split_plan, and the live-range rule the core
    applies per sequence) cover keys [0, active) exactly once at every
    length 0-4096: active is the length capped at the capacity, or the
    whole capacity at length 0."""
    plan = split_plan(batch, kv, capacity, H100_SMS, split_keys)
    assert plan.n_splits == -(-capacity // plan.split_keys)
    assert (plan.n_splits - 1) * plan.split_keys < capacity  # no split starts past the cache
    sk = plan.split_keys
    for length in range(0, 4097):
        # the core's rule (decode_attention.cuh): active keys, live splits
        active = min(length, capacity) if length > 0 else capacity
        ranges = [(c * sk, min((c + 1) * sk, active)) for c in range(plan.n_splits)
                  if c * sk < active]
        assert 1 <= len(ranges) <= plan.n_splits
        covered = [t for a, b in ranges for t in range(a, b)]
        assert covered == list(range(active)), (length, ranges)
        assert all(0 < b - a <= plan.split_keys for a, b in ranges)


def test_split_plan_shapes():
    """One split at serving contexts (no combine); at yi-6b widths and 4096
    keys, about a block per SM of the card; at most MAX_SPLIT_KEYS a split;
    an explicit split size is kept."""
    from repro_torch.kernels.decode_attention import MAX_SPLIT_KEYS, ROUND_KEYS

    assert split_plan(4, 4, 80, H100_SMS).n_splits == 1
    assert split_plan(4, 4, 128, H100_SMS).n_splits == 1
    for sms in (H100_SMS, 114, 78):  # H100 SXM, H100 PCIe, a smaller card
        k5 = split_plan(4, 4, 4096, sms)  # over its 16 (sequence, kv head) pairs
        assert sms // 2 <= k5.n_splits * 16 <= 2 * sms and k5.split_keys % ROUND_KEYS == 0
    assert split_plan(4, 4, 4096, H100_SMS).split_keys == 512
    assert split_plan(64, 8, 100_000, H100_SMS).split_keys == MAX_SPLIT_KEYS
    assert split_plan(2, 4, 64, H100_SMS, 16) == SplitPlan(4, 16)
    with pytest.raises(ValueError):
        split_plan(2, 4, 64, H100_SMS, 0)


def test_decode_attention_plain_respects_lengths_and_keeps_dtype():
    q, k, v, _ = _k5_case((2, 64, 4, 2, 16, 16), seed=1)
    lens = torch.tensor([5, 64], dtype=torch.int32)
    out = decode_attention_ref(*map(torch.from_numpy, (q, k, v)), lens)
    short = decode_attention_ref(torch.from_numpy(q[:1]), torch.from_numpy(k[:1, :5]),
                                 torch.from_numpy(v[:1, :5]), lens[:1])
    torch.testing.assert_close(out[0], short[0], rtol=2e-5, atol=2e-5)
    qb, kb, vb = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    assert decode_attention_ref(qb, kb, vb, lens).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_kernel(*map(torch.from_numpy, (q, k, v)), lens)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K1_SHAPES, ids=K1_IDS)
def test_cuda_plam_matmul_bit_identical(cuda_device, shape):
    a, b = (torch.from_numpy(t).to(cuda_device) for t in _ragged_operands(shape))
    for bb in (b, pack16(b)):  # int32 and int16 patterns take different load paths
        got = ops.plam_matmul_bits(a, bb, P16)
        assert torch.equal(got.view(torch.int32),
                           ops.plam_matmul_bits(a, bb, P16, use_kernel=False).view(torch.int32))
        assert torch.equal(got.cpu(), ops.plam_matmul_bits(a.cpu(), b.cpu(), P16))


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(PREFILL_EDGE_SHAPES)), ids=PREFILL_IDS)
def test_cuda_plam_matmul_prefill_edges_bit_identical(cuda_device, case):
    """The kernel's prefill path at the full edge shapes against its plain
    version: pattern, f32 and bf16 A; int32 and int16 B."""
    a, b, x = (torch.from_numpy(t).to(cuda_device)
               for t in _prefill_operands(PREFILL_EDGE_SHAPES[case], case))
    for fn, xa in [(ops.plam_matmul_bits, a), (ops.plam_dense, x),
                   (ops.plam_dense, x.to(torch.bfloat16))]:
        want = fn(xa, b, P16, use_kernel=False).view(torch.int32)
        for bb in (b, pack16(b)):
            assert torch.equal(fn(xa, bb, P16).view(torch.int32), want)


@pytest.mark.cuda
def test_cuda_posit_codec_bit_identical(cuda_device):
    pats = torch.arange(1 << 16, dtype=torch.int32, device=cuda_device)
    assert torch.equal(ops.posit_decode(pats, P16).view(torch.int32),
                       ops.posit_decode(pats, P16, use_kernel=False).view(torch.int32))
    x = torch.randn(1 << 16, device=cuda_device) * 1e3
    assert torch.equal(ops.posit_encode(x, P16), ops.posit_encode(x, P16, use_kernel=False))


@pytest.mark.cuda
@pytest.mark.parametrize("n,es", TABLE_SPECS, ids=TABLE_IDS)
def test_cuda_bf16_table_equals_plain(cuda_device, n, es):
    spec = PositSpec(n, es)
    assert torch.equal(pc.bf16_table(spec, cuda_device).cpu(), pc.bf16_table_plain(spec))


@pytest.mark.cuda
@pytest.mark.parametrize("n,es", TABLE_PATH_SPECS,
                         ids=[f"p{n}es{es}" for n, es in TABLE_PATH_SPECS])
def test_cuda_encode_both_paths_bit_identical(cuda_device, n, es):
    """All 65,536 bf16 patterns tiled and shuffled to 2^20 + 13 lanes:
    the table path over the whole, the computed path over two halves, and
    inputs at element offsets 1, 2 and 4 (head lanes; the output off its
    16-byte boundary, or on it after the head at 4 -> int32)."""
    spec, size = PositSpec(n, es), pc.TABLE_MIN_NUMEL + 13
    x = _tiled_bf16(size).to(cuda_device)
    assert pc.encode_path(x.dtype, size, spec) == "table"
    h = size // 2
    for od in (torch.int16, torch.int32):
        want = pc.encode_plain(x, spec, od)
        assert torch.equal(ops.posit_encode(x, spec, out_dtype=od), want)
        halves = [ops.posit_encode(part, spec, out_dtype=od) for part in (x[:h], x[h:])]
        assert torch.equal(torch.cat(halves), want)
        for off in (1, 2, 4):
            assert torch.equal(ops.posit_encode(x[off:], spec, out_dtype=od), want[off:])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WEIGHT_SHAPES, ids=["wkv", "wgu", "unembed"])
def test_cuda_encode_weight_shapes_bit_identical(cuda_device, shape):
    """Seeded bf16 weights at the serve path's shapes, where the table
    path's grid is capped at one block an SM and each thread's loop strides many
    times, against the plain version computed 2^25 lanes at a time."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    w = (torch.randn(shape, generator=g, device=cuda_device) * shape[0] ** -0.5).bfloat16()
    rows = max(1, (1 << 25) // shape[1])
    for od in (torch.int16, torch.int32):
        want = torch.cat([pc.encode_plain(w[r:r + rows], P16, od)
                          for r in range(0, shape[0], rows)])
        assert torch.equal(ops.posit_encode(w, P16, out_dtype=od), want)


@pytest.mark.cuda
def test_cuda_encode_at_the_table_threshold(cuda_device):
    x = _tiled_bf16(pc.TABLE_MIN_NUMEL + 7, seed=1).to(cuda_device)
    for size in (pc.TABLE_MIN_NUMEL + d for d in (-1, 0, 1, 7)):
        for od in (torch.int16, torch.int32):
            assert torch.equal(ops.posit_encode(x[:size], P16, out_dtype=od),
                               pc.encode_plain(x[:size], P16, od))


@pytest.mark.cuda
@pytest.mark.parametrize("n,es", [(16, 1), (16, 2), (32, 2)])
def test_cuda_encode_f32_sweep_bit_identical(cuda_device, n, es):
    """f32 values over every scale and the edges (Posit<16,1>: the spec
    compiled in), aligned and at an odd element offset."""
    spec = PositSpec(n, es)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(1 << 18) * np.exp2(rng.integers(-140, 128, 1 << 18))).astype(
        np.float32)
    x[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -3e38, 1.0]
    xt = torch.from_numpy(x).to(cuda_device)
    for od in (torch.int16, torch.int32) if n <= 16 else (torch.int32,):
        for part in (xt, xt[3:]):
            assert torch.equal(ops.posit_encode(part, spec, out_dtype=od),
                               pc.encode_plain(part, spec, od))


@pytest.mark.cuda
def test_cuda_paged_attention_close_to_plain(cuda_device):
    q, kp, vp, tables, lengths = (torch.from_numpy(t).to(cuda_device)
                                  for t in _paged_case(seed=3))
    got = paged_decode_attention(q, kp, vp, tables, lengths)
    want = paged_decode_attention_ref(q, kp, vp, tables, lengths)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["plam_mul_elementwise", "exact_mul_elementwise"])
@pytest.mark.parametrize("case", ["p8es1_exhaustive", "p16es1_ragged1000"])
def test_cuda_posit_mul_bit_identical(cuda_device, fn, case):
    _, spec, pa, pb = _k4_operands(case)
    a, b = torch.from_numpy(pa).to(cuda_device), torch.from_numpy(pb).to(cuda_device)
    got = getattr(ops, fn)(a, b, spec)
    assert torch.equal(got, getattr(ops, fn)(a, b, spec, use_kernel=False))
    assert torch.equal(got.cpu(), getattr(ops, fn)(a.cpu(), b.cpu(), spec))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K5_SHAPES, ids=["x".join(map(str, s)) for s in K5_SHAPES])
def test_cuda_decode_attention_close_to_plain(cuda_device, shape):
    q, k, v, lens = (torch.from_numpy(t).to(cuda_device) for t in _k5_case(shape, seed=4))
    got = decode_attention(q, k, v, lens, blk=shape[-1])
    want = decode_attention(q, k, v, lens, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# K2 and K5 at the length edges on the card: 0, 1, bs - 1, bs, bs + 1, a
# round of the block's 16-key tiles +- 1 (64 keys with four warps, 128
# with eight), the split plan's edge +- 1 (capacity 320 gives two splits
# of 256 keys) and the full cache
EDGE_BS, EDGE_MAX_BLK = 8, 40
EDGE_CAP = EDGE_BS * EDGE_MAX_BLK
EDGE_LENGTHS = (0, 1, 7, 8, 9, 63, 64, 65, 127, 128, 129, 255, 256, 257, EDGE_CAP - 1,
                EDGE_CAP)
EDGE_DTYPES = [("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16"), ("bf16", "f32")]
_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,hd", [(8, 2, 32), (12, 1, 64), (4, 4, 128)],
                         ids=["g4hd32", "g12hd64", "g1hd128"])
@pytest.mark.parametrize("dtypes", EDGE_DTYPES, ids=["-".join(d) for d in EDGE_DTYPES])
def test_cuda_paged_attention_length_edges(cuda_device, h, kv, hd, dtypes):
    sms = card_sms(torch.cuda.current_device())
    assert split_plan(len(EDGE_LENGTHS), kv, EDGE_CAP, sms).split_keys == 256
    q, kp, vp, tables, lens = (
        torch.from_numpy(t).to(cuda_device)
        for t in _paged_case(seed=6, lengths=EDGE_LENGTHS, max_blk=EDGE_MAX_BLK, h=h, kv=kv,
                             hd=hd, bs=EDGE_BS))
    q, kp, vp = q.to(_DT[dtypes[0]]), kp.to(_DT[dtypes[1]]), vp.to(_DT[dtypes[1]])
    got = paged_decode_attention(q, kp, vp, tables, lens)
    assert got.dtype == q.dtype and torch.isfinite(got.float()).all()
    want = paged_decode_attention_ref(q.float(), kp.float(), vp.float(), tables, lens)
    if dtypes == ("f32", "f32"):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:  # chip_smoke.py's K2 tolerances: f32 result, then the plain bf16 one
        assert float((got.float() - want).abs().max()) <= 1e-2
        plain = paged_decode_attention_ref(q, kp, vp, tables, lens).float()
        assert float((got.float() - plain).abs().max()) <= 6e-2


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,hd", [(8, 2, 32), (12, 1, 64), (4, 4, 128)],
                         ids=["g4hd32", "g12hd64", "g1hd128"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_decode_attention_length_edges(cuda_device, h, kv, hd, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    b = len(EDGE_LENGTHS)
    q = torch.randn((b, h, hd), generator=g, device=cuda_device)
    k, v = (torch.randn((b, EDGE_CAP, kv, hd), generator=g, device=cuda_device)
            for _ in range(2))
    lens = torch.tensor(EDGE_LENGTHS, dtype=torch.int32, device=cuda_device)
    q, k, v = (t.to(_DT[dtype]) for t in (q, k, v))
    got = decode_attention(q, k, v, lens)
    assert got.dtype == q.dtype and torch.isfinite(got.float()).all()
    exact = decode_attention(q.float(), k.float(), v.float(), lens, use_kernel=False)
    if dtype == "f32":
        torch.testing.assert_close(got, exact, rtol=1e-4, atol=1e-4)
    else:  # one rounding to bf16 of the f32 result, plus the order of the sums
        assert float(((got.float() - exact).abs() - 2.0 ** -8 * exact.abs()).max()) <= 2e-6


@pytest.mark.cuda
def test_cuda_attention_refuses_shapes_it_was_not_built_for(cuda_device):
    q, kp, vp, tables, lens = (torch.from_numpy(t).to(cuda_device)
                               for t in _paged_case(seed=3))
    with pytest.raises(ValueError, match="head dim"):
        paged_decode_attention(q[..., :8].contiguous(), kp[..., :8].contiguous(),
                               vp[..., :8].contiguous(), tables, lens)
    k = torch.zeros((1, 16, 1, 16), device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        decode_attention(torch.zeros((1, 17, 16), device=cuda_device), k, k,
                         torch.ones(1, dtype=torch.int32, device=cuda_device))
