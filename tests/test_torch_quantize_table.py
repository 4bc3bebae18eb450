"""K3's quantize table path and the decode on prequantized weights.

On the CPU: the plain quantize table (the bf16 bits of decode(encode(|x|))
for the 32,768 non-negative bf16 patterns) with its sign rule against the
JAX reference's ``posit_quantize`` (the Pallas kernel in interpret mode)
over all 65,536 bf16 patterns; the premise that every entry is a bf16
value; a torch mirror of the kernel's lookup against ``quantize_plain``;
the quantize's choice of path by ``encode_path``; and the decode of prequantized patterns
(``_pattern_matmul`` under posit_quant, ``dequantize_params``) through
``posit_decode`` against the reference.  The JAX tests import JAX inside
themselves, so that the ``cuda`` cases, which hold the kernels against
their plain versions, run on a card without it.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import posit_codec as pc
from repro_torch.numerics import P16, PositSpec


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops (the suite runs in
    parallel workers on shared cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# the specs of tests/test_torch_kernels.py's encode table, and <16,3>
TABLE_SPECS = [(16, 1), (16, 2), (16, 0), (12, 1), (10, 1), (8, 1), (8, 0), (6, 0)]
QUANT_SPECS = TABLE_SPECS + [(16, 3)]
QUANT_IDS = [f"p{n}es{es}" for n, es in QUANT_SPECS]
TABLE_PATH_SPECS = [(16, 1), (16, 2), (10, 1), (8, 0)]
PATH_IDS = [f"p{n}es{es}" for n, es in TABLE_PATH_SPECS]
NAN_BITS = 0x7FC00000


def _jax():
    pytest.importorskip("jax")


def _all_bf16_bits() -> np.ndarray:
    """The 65,536 bf16 patterns, in order, as uint32."""
    return np.arange(1 << 16, dtype=np.uint32)


def _lookup_np(bits: np.ndarray, table: torch.Tensor) -> np.ndarray:
    """The kernel's lane, in numpy: the magnitude's entry, with the sign
    bit set where x is negative and the entry is neither +0 nor NaN, as
    f32 bits."""
    tab = table.numpy().view(np.uint16).astype(np.uint32)
    t = tab[bits & 0x7FFF]
    neg = ((bits & 0x8000) != 0) & (t != 0) & (t != 0x7FC0)
    return np.where(neg, t | 0x8000, t).astype(np.uint32) << 16


def _lookup_torch(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """csrc/posit_codec.cu's quantize table lane, plain, on a bf16 tensor:
    f32 out."""
    r = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    t = table.to(torch.int32)[(r & 0x7FFF).long()] & 0xFFFF
    neg = ((r & 0x8000) != 0) & (t != 0) & (t != 0x7FC0)
    return (torch.where(neg, t | 0x8000, t) << 16).view(torch.float32)


@pytest.mark.parametrize("n,es", QUANT_SPECS, ids=QUANT_IDS)
def test_quantize_table_plain_with_sign_rule_matches_jax_quantize(n, es):
    """The plain table with the sign rule gives the reference's Pallas
    quantize (interpret mode) of every bf16 pattern, f32 bit for bit: +-0,
    subnormals, values beyond maxpos, inf and NaN included."""
    _jax()
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.numerics import PositSpec as JSpec

    table = pc.quantize_table_plain(PositSpec(n, es))
    assert table.shape == (pc.TABLE_ENTRIES,) and table.dtype == torch.int16
    bits = _all_bf16_bits()
    x = jnp.asarray((bits << 16).view(np.float32))
    want = np.asarray(jops.posit_quantize(x, JSpec(n, es), interpret=True)).view(np.uint32)
    assert np.array_equal(_lookup_np(bits, table), want)


@pytest.mark.parametrize("n,es", QUANT_SPECS, ids=QUANT_IDS)
def test_quantized_bf16_values_are_bf16(n, es):
    """The premise of the table: decode(encode(x)) of every bf16 x is a
    bf16 value (low 16 bits 0), every inf and NaN gives the NaN
    0x7FC00000, and q(-x) is q(x) with the sign bit set except where q(x)
    is +0 or NaN."""
    spec = PositSpec(n, es)
    bits = torch.arange(1 << 16, dtype=torch.int32)
    q = pc.quantize_plain(bits.to(torch.int16).view(torch.bfloat16), spec).view(torch.int32)
    assert not bool((q & 0xFFFF).any())
    special = (bits & 0x7F80) == 0x7F80
    assert bool((q[special] == NAN_BITS).all())
    pos, neg = q[: 1 << 15], q[1 << 15:]
    keep = (pos == 0) | (pos == NAN_BITS)
    assert torch.equal(neg, torch.where(keep, pos, pos | torch.tensor(-(1 << 31))))


def _specials_bf16(seed: int, n: int) -> torch.Tensor:
    """n seeded bf16 values over every scale, with +-0, +-inf, NaN,
    subnormals and values beyond +-maxpos planted."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-140, 120, n))).astype(np.float32)
    x[:12] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 9e-39, 3e38, -3e38,
              2.0 ** 100, -(2.0 ** -100)]
    rng.shuffle(x)
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("n,es", QUANT_SPECS, ids=QUANT_IDS)
def test_quantize_lookup_mirror_equals_quantize_plain(n, es):
    """The kernel's lookup, plain, equals quantize_plain on seeded bf16
    tensors with the special values, bit for bit."""
    spec = PositSpec(n, es)
    x = _specials_bf16(n * 10 + es, 20_000)
    table = pc.quantize_table_plain(spec)
    got = _lookup_torch(x, table)
    want = pc.quantize_plain(x, spec)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_quantize_path_rule(monkeypatch):
    """The quantize takes the encode's rule, ``encode_path``: posit_quantize
    hands its launch the quantize table for bf16 with n <= 16 from
    TABLE_MIN_NUMEL lanes, and no table for f32, n > 16 and fewer lanes
    (meta tensors, with the launch and the table recorded, not run)."""
    tables = []
    monkeypatch.setattr(pc._lib, "wants_kernel", lambda t, use_kernel: True)
    monkeypatch.setattr(pc._lib, "require", lambda *a, **kw: None)
    monkeypatch.setattr(pc, "quantize_table", lambda spec, device: f"table {spec.n},{spec.es}")
    monkeypatch.setattr(pc, "_quantize_launch",
                        lambda x, out, spec, table, counter: tables.append(table))
    th, bf = pc.TABLE_MIN_NUMEL, torch.bfloat16
    cases = [(bf, numel, PositSpec(n, es)) for n, es in QUANT_SPECS
             for numel in (th - 1, th, th + 1)]
    cases += [(dt, numel, spec) for numel in (th - 1, th, th + 1)
              for dt, spec in ((bf, PositSpec(17, 1)), (torch.float32, P16))]
    cases += [(bf, 1024 * 4096, P16), (bf, 4 * 64 * 1536, P16)]  # training, serving
    for dt, numel, spec in cases:
        want = pc.encode_path(dt, numel, spec)
        assert want == ("table" if dt == bf and spec.n <= 16 and numel >= th else "computed")
        pc.posit_quantize(torch.empty(numel, dtype=dt, device="meta"), spec)
        assert tables.pop() == (f"table {spec.n},{spec.es}" if want == "table" else None)


def test_chip_smoke_reads_the_quantize_hand_counts():
    """The constants chip_smoke.py reads for K3's design floors are in
    posit_codec.cu, and the quantize's two are the sums its header
    states."""
    src = (pathlib.Path(pc.__file__).with_name("csrc") / "posit_codec.cu").read_text()
    smoke = (pathlib.Path(__file__).parents[1] / "chip_smoke.py").read_text()
    counts = {}
    for name in ("kEncodeFixedAluOpsPerLane", "kDecodeFixedAluOpsPerLane",
                 "kQuantizeFixedAluOpsPerLane", "kQuantizeTableAluOpsPerLane"):
        counts[name] = int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
        assert name in smoke
    assert counts["kQuantizeFixedAluOpsPerLane"] == (counts["kEncodeFixedAluOpsPerLane"]
                                                     + counts["kDecodeFixedAluOpsPerLane"])


def test_chip_smoke_reads_the_by_lane_threshold():
    """The lane counts below which the computed paths take one lane a
    thread (the decode's, the encode's and quantize's) are constants of
    posit_codec.cu that chip_smoke.py reads (its checks at each edge, its
    timed rows on both sides) and the CUDA tests below use; they lie below
    the table threshold or at it."""
    src = (pathlib.Path(pc.__file__).with_name("csrc") / "posit_codec.cu").read_text()
    smoke = (pathlib.Path(__file__).parents[1] / "chip_smoke.py").read_text()
    edges = _by_lane_max_lanes()
    assert edges == {"decode": 1 << 17, "quantize": 1 << 20}
    assert all(0 < e <= pc.TABLE_MIN_NUMEL for e in edges.values())
    for name in ("kDecodeByLaneMaxLanes", "kByLaneMaxLanes"):
        assert src.count(f"constexpr int64_t {name} = ") == 1
        assert name in smoke


def _by_lane_max_lanes():
    src = (pathlib.Path(pc.__file__).with_name("csrc") / "posit_codec.cu").read_text()
    return {op: int(re.search(rf"constexpr int64_t {c} = (\d+);", src).group(1))
            for op, c in (("decode", "kDecodeByLaneMaxLanes"), ("quantize", "kByLaneMaxLanes"))}


def _counting_decode(monkeypatch):
    """Calls of the codec's posit_decode wrapper, by pattern dtype."""
    calls = []
    real = pc.posit_decode

    def counted(bits, *a, **kw):
        calls.append(bits.dtype)
        return real(bits, *a, **kw)

    monkeypatch.setattr(pc, "posit_decode", counted)
    return calls


@pytest.mark.parametrize("carrier", ["f32", "bf16"])
@pytest.mark.parametrize("pat_dtype", ["int16", "int32"])
def test_pattern_matmul_posit_quant_decodes_through_the_codec(pat_dtype, carrier,
                                                              monkeypatch):
    """Prequantized weights under posit_quant: the patterns go through
    posit_decode (its plain version on the CPU) and the product is the
    reference's (f32 order: 1e-5; the bf16 carrier rounds its product
    once: 1e-2)."""
    _jax()
    import jax.numpy as jnp

    from repro.core.modes import NumericsConfig as JCfg
    from repro.core.modes import nmatmul as j_nmatmul
    from repro.numerics import PositSpec as JSpec
    from repro.numerics import encode, pack16
    from repro_torch.core.modes import NumericsConfig as TCfg
    from repro_torch.core.modes import nmatmul

    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 40)).astype(np.float32)
    w = encode(jnp.asarray(rng.standard_normal((40, 12)) * 40 ** -0.5, jnp.float32),
               JSpec(16, 1))
    w = np.array(pack16(w) if pat_dtype == "int16" else w)
    want = np.asarray(j_nmatmul(jnp.asarray(x), jnp.asarray(w),
                                JCfg(mode="posit_quant", carrier=carrier)), np.float32)
    calls = _counting_decode(monkeypatch)
    _lib.reset_launches()
    got = nmatmul(torch.from_numpy(x), torch.from_numpy(w),
                  TCfg(mode="posit_quant", carrier=carrier))
    assert calls == [getattr(torch, pat_dtype)]
    assert _lib.launches["posit_codec"] == 0  # the plain version on the CPU
    tol = 1e-2 if carrier == "bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_dequantize_params_gives_the_reference_values(monkeypatch):
    """dequantize_params decodes every prequantized weight through
    posit_decode to the reference's dequantize_params values, bit for
    bit."""
    _jax()
    import dataclasses

    import jax

    from repro.configs import get_config as j_get_config
    from repro.core.prequant import dequantize_params as j_dequantize
    from repro.core.prequant import quantize_params as j_quantize
    from repro.models import build as j_build
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core.prequant import dequantize_params
    from repro_torch.core.prequant import quantize_params as t_quantize

    def reduced(get):
        cfg = dataclasses.replace(get("yi-6b").reduced(), param_dtype="float32",
                                  act_dtype="float32")
        return cfg.with_numerics("default=posit_quant:16:1")

    jc, tc = reduced(j_get_config), reduced(t_get_config)
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    numpy_tree = jax.tree.map(np.asarray, jp)
    tm, tmeta = t_quantize(tc, params_from_jax(numpy_tree, tc, device="cpu"))
    jq, jmeta = j_quantize(jc, jp)
    assert tmeta == jmeta and tmeta
    want = j_dequantize(jq, jmeta)
    calls = _counting_decode(monkeypatch)
    dequantize_params(tm, tmeta)
    n_quantized = sum(tc.n_layers if path.startswith("layers/") else 1 for path in tmeta)
    assert len(calls) == n_quantized
    for i in range(tc.n_layers):
        for sub, name in (("attn", "wq"), ("attn", "wk"), ("mlp", "wd")):
            got = getattr(getattr(tm.blocks[i], sub), name)
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want["layers"][sub][name][i]).view(np.uint32))
    assert np.array_equal(tm.unembed.numpy().view(np.uint32),
                          np.asarray(want["unembed"]).view(np.uint32))


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


def _tiled_bf16(n: int, seed: int = 0) -> torch.Tensor:
    """n lanes of the 65,536 bf16 patterns tiled and shuffled."""
    pats = np.tile(np.arange(1 << 16, dtype=np.uint16), n // (1 << 16) + 1)[:n]
    np.random.default_rng(seed).shuffle(pats)
    return torch.from_numpy(pats.view(np.int16).copy()).view(torch.bfloat16)


def _same(got, want):
    return got.shape == want.shape and torch.equal(got.view(torch.int32),
                                                   want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,es", QUANT_SPECS, ids=QUANT_IDS)
def test_cuda_quantize_table_equals_plain(cuda_device, n, es):
    spec = PositSpec(n, es)
    assert torch.equal(pc.quantize_table(spec, cuda_device).cpu(), pc.quantize_table_plain(spec))


@pytest.mark.cuda
@pytest.mark.parametrize("n,es", TABLE_PATH_SPECS, ids=PATH_IDS)
def test_cuda_quantize_both_paths_bit_identical(cuda_device, n, es):
    """All 65,536 bf16 patterns tiled and shuffled to 2^20 + 13 lanes:
    the table path over the whole and at element offsets 1, 2 and 4, the
    computed path over two halves."""
    spec, size = PositSpec(n, es), pc.TABLE_MIN_NUMEL + 13
    x = _tiled_bf16(size).to(cuda_device)
    assert pc.encode_path(x.dtype, size, spec) == "table"
    want = pc.quantize_plain(x, spec)
    assert _same(pc.posit_quantize(x, spec), want)
    h = size // 2
    assert _same(torch.cat([pc.posit_quantize(x[:h], spec), pc.posit_quantize(x[h:], spec)]),
                 want)
    for off in (1, 2, 4):
        assert _same(pc.posit_quantize(x[off:], spec), want[off:])


@pytest.mark.cuda
def test_cuda_quantize_at_the_table_threshold(cuda_device):
    x = _tiled_bf16(pc.TABLE_MIN_NUMEL + 7, seed=1).to(cuda_device)
    for size in (pc.TABLE_MIN_NUMEL + d for d in (-1, 0, 1, 7)):
        assert _same(pc.posit_quantize(x[:size], P16), pc.quantize_plain(x[:size], P16))


@pytest.mark.cuda
@pytest.mark.parametrize("n,es", [(16, 1), (16, 2), (32, 2)])
def test_cuda_quantize_f32_sweep_bit_identical(cuda_device, n, es):
    """f32 values over every scale and the edges on the computed path
    (Posit<16,1>: the spec compiled in), aligned and at an odd offset."""
    spec = PositSpec(n, es)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(1 << 18) * np.exp2(rng.integers(-140, 128, 1 << 18))).astype(
        np.float32)
    x[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -3e38, 1.0]
    xt = torch.from_numpy(x).to(cuda_device)
    for part in (xt, xt[3:]):
        assert _same(pc.posit_quantize(part, spec), pc.quantize_plain(part, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("n,es", TABLE_PATH_SPECS, ids=PATH_IDS)
def test_cuda_decode_all_patterns_bit_identical(cuda_device, n, es):
    """Every 16-bit pattern, int16 and int32, aligned and at offset 1."""
    spec = PositSpec(n, es)
    pats = torch.arange(1 << 16, dtype=torch.int32, device=cuda_device)
    for bits in (pats, ((pats ^ 0x8000) - 0x8000).to(torch.int16)):
        for part in (bits, bits[1:]):
            assert _same(pc.posit_decode(part, spec), pc.decode_plain(part, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("n,es", [(16, 1), (10, 1)])
def test_cuda_decode_at_full_weight_size_bit_identical(cuda_device, n, es):
    """Every 16-bit pattern tiled and shuffled to 2^24 + 13 lanes, where
    each thread of the decode's grid takes more than two chunks (its
    two-in-flight loop), int16 and int32, aligned and at offset 1."""
    spec = PositSpec(n, es)
    bits16 = _tiled_bf16((1 << 24) + 13, seed=2).view(torch.int16).to(cuda_device)
    for bits in (bits16, bits16.to(torch.int32) & 0xFFFF):
        for part in (bits, bits[1:]):
            assert _same(pc.posit_decode(part, spec), pc.decode_plain(part, spec))


@pytest.mark.cuda
def test_cuda_computed_paths_at_the_by_lane_threshold(cuda_device):
    """The decode and the computed quantize at one lane a thread and in
    8-lane chunks: each threshold - 1, its value and + 1 lanes, aligned
    and at offset 1."""
    edges = _by_lane_max_lanes()
    x = _tiled_bf16(max(edges.values()) + 9, seed=3).to(cuda_device)
    bits = x.view(torch.int16)
    for op, edge in edges.items():
        for size in (edge - 1, edge, edge + 1):
            for off in (0, 1):
                part = slice(off, off + size)
                if op == "decode":
                    assert _same(pc.posit_decode(bits[part], P16),
                                 pc.decode_plain(bits[part], P16))
                    continue
                xf = x[part].float()
                assert _same(pc.posit_quantize(xf, P16), pc.quantize_plain(xf, P16))
                if size < pc.TABLE_MIN_NUMEL:  # bf16 from 2^20 lanes takes the table
                    assert _same(pc.posit_quantize(x[part], P16), pc.quantize_plain(x[part], P16))

