"""K1 with the activation encode inside it (``plam_matmul_float``, the
route of ``ops.plam_dense``): the premise of its A loader against the
reference, its plain version against the JAX ``plam_dense`` for bf16
activations, and the CUDA kernel against its plain version on the card
(``cuda`` marker).

On the CPU every wrapper takes its plain version; the launch counters
must stay 0 here.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.plam_matmul import _log_words as j_log_words  # noqa: E402
from repro.numerics import PositSpec as JSpec  # noqa: E402
from repro.numerics import encode as j_encode  # noqa: E402
from repro_torch.kernels import _lib, ops  # noqa: E402
from repro_torch.kernels.plam_matmul import plam_matmul_float  # noqa: E402
from repro_torch.numerics import P16, PositSpec, pack16  # noqa: E402
from test_torch_kernels import K1_IDS, K1_SHAPES, _bits, _ragged_operands  # noqa: E402

ALL_BF16 = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    """Nothing in this file launches a kernel unless a card is present."""
    _lib.reset_launches()
    yield
    if not torch.cuda.is_available():
        assert all(v == 0 for v in _lib.launches.values()), _lib.launches


def _exact_bf16_range(n, es):
    """posit.cuh's exact_bf16_lo/hi: the scales at which the regime leaves
    es exponent bits and a bf16's 7 fraction bits; None when empty."""
    mmax = n - 1 - es - 7
    if mmax < 2:
        return None
    return (1 - mmax) * (1 << es), (mmax - 1) * (1 << es) - 1


def _reference_words(x: np.ndarray, n: int, es: int) -> np.ndarray:
    """log_words(encode(x)) of the reference, with the sign folded in as
    the kernel does (lmag + sign << 31; 0 for zero and NaR)."""
    spec = JSpec(n, es)
    s31, lmag, valid = j_log_words(j_encode(jnp.asarray(x), spec), spec)
    words = np.asarray(lmag).view(np.uint32) + np.asarray(s31).astype(np.uint32)
    return np.where(np.asarray(valid), words, np.uint32(0))


@pytest.mark.parametrize("n,es", [(16, 1), (16, 0), (16, 2), (12, 1), (10, 0), (24, 2),
                                  (8, 0)])
def test_bf16_log_word_is_its_own_bits_in_the_exact_range(n, es):
    """The premise of the fused A loader, over all 65,536 bf16 patterns:
    at every scale of the spec's exact range, every finite non-zero bf16
    value's sign-folded log word equals its f32 bits, and the range is
    tight (a value just outside it on either side differs).  Where the
    range is empty (Posit<8,0>), no scale has all its values equal."""
    words = _reference_words(ALL_BF16, n, es)
    raw = ALL_BF16.view(np.uint32)
    scale = ((raw >> 23) & 0xFF).astype(np.int64) - 127
    finite_nonzero = (scale != 128) & ((raw & 0x7FFFFFFF) != 0)
    rng = _exact_bf16_range(n, es)
    if (n, es) == (16, 1):
        assert rng == (-12, 11)
    if rng is None:
        for e in range(-127, 128):
            at = finite_nonzero & (scale == e)
            assert (words[at] != raw[at]).any(), e
        return
    lo, hi = rng
    for e in range(lo, hi + 1):
        at = finite_nonzero & (scale == e)
        assert at.sum() == 256 and np.array_equal(words[at], raw[at]), e
    for e in (lo - 1, hi + 1):
        at = finite_nonzero & (scale == e)
        assert (words[at] != raw[at]).any(), e


def test_bf16_log_word_outside_the_range_needs_the_full_encode():
    """Zero and NaR give word 0; outside [-12, 11] at Posit<16,1> the word
    is the rounded or saturated posit's, which the copy would get wrong."""
    words = _reference_words(ALL_BF16, 16, 1)
    raw = ALL_BF16.view(np.uint32)
    scale = ((raw >> 23) & 0xFF).astype(np.int64) - 127
    assert (words[(raw & 0x7FFFFFFF) == 0] == 0).all()
    assert (words[scale == 128] == 0).all()  # inf and NaN encode to NaR
    for e in (12, -13, 27, -27, -127):
        at = (scale == e) & ((raw & 0x7FFFFFFF) != 0)
        assert (words[at] != raw[at]).any(), e


def _bf16(x: np.ndarray) -> torch.Tensor:
    """f32 values rounded to bf16 (torch's RNE), as a torch bf16 tensor."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)


def _j_bf16(t: torch.Tensor):
    return jnp.asarray(t.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16))


# planted in x: +-0, +-inf, NaN, a subnormal, and bf16 values at scales
# 11 and -12 (inside the exact range) and 12 and -13 (just outside)
SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -(2.0 ** -130),
                     1.5 * 2.0 ** 11, -1.9921875 * 2.0 ** 11, 1.25 * 2.0 ** 12,
                     -1.0078125 * 2.0 ** 12, 1.75 * 2.0 ** -12, -2.0 ** -12,
                     1.5 * 2.0 ** -13, -1.9921875 * 2.0 ** -13], np.float32)


def _activations(m: int, k: int) -> np.ndarray:
    x = np.random.default_rng(k + 7 * m).standard_normal((m, k)).astype(np.float32)
    step = max(1, x.size // len(SPECIALS))
    x.flat[::step] = np.resize(SPECIALS, x.flat[::step].shape)
    return x


@pytest.mark.parametrize("shape", K1_SHAPES, ids=K1_IDS)
def test_plam_dense_bf16_plain_bit_identical_to_jax_kernel(shape):
    """plam_dense with bf16 activations (the serving path's dtype) == the
    JAX Pallas path in interpret mode on the same bf16 values, bit for
    bit, with every special value of SPECIALS among them."""
    m, k, n = shape
    _, b = _ragged_operands(shape)
    x = _bf16(_activations(m, k))
    want = jops.plam_dense(_j_bf16(x), jnp.asarray(b), JSpec(16, 1), interpret=True)
    got = ops.plam_dense(x, torch.from_numpy(b), P16)
    assert np.array_equal(_bits(want), got.numpy().view(np.uint32))
    got16 = ops.plam_dense(x, pack16(torch.from_numpy(b)), P16)
    assert torch.equal(got16.view(torch.int32), got.view(torch.int32))


def test_plam_matmul_float_plain_is_the_two_step_composition():
    """The fused wrapper's plain version is encode, then the PLAM matmul,
    for f32 and bf16 x, int32 and int16 B."""
    x = _activations(5, 40)
    _, b = _ragged_operands((5, 40, 9))
    bt = torch.from_numpy(b)
    for xt in (torch.from_numpy(x), _bf16(x)):
        a_bits = ops.posit_encode(xt, P16)
        want = ops.plam_matmul_bits(a_bits, bt, P16)
        for bb in (bt, pack16(bt)):
            got = plam_matmul_float(xt, bb, P16)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_plam_matmul_float_checks_its_operands():
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="shapes"):
        plam_matmul_float(x, torch.zeros((4, 2), dtype=torch.int32), P16)
    with pytest.raises(ValueError, match="int16"):
        plam_matmul_float(x, torch.zeros((3, 2), dtype=torch.int16), PositSpec(24, 1))
    with pytest.raises(ValueError, match="CUDA"):
        plam_matmul_float(x, torch.zeros((3, 2), dtype=torch.int32), P16, use_kernel=True)


# -- on the card ---------------------------------------------------------------

# (M, K, N): every decode-batch M and both branch edges (1-5, 16, 17) and
# the prefill path (64); K = 4096, an odd K (33, 4095: bf16 rows then
# start off 4 bytes, so A is read with guarded 2-byte loads); N = 4096,
# 512, 11008 and N that is not a multiple of 8 (scalar B loads)
FUSED_SHAPES = [(1, 4096, 4096), (2, 33, 512), (3, 4095, 11008), (4, 4096, 520),
                (5, 33, 4100), (16, 4095, 4096), (17, 4096, 512), (64, 33, 11008),
                (4, 4096, 11008), (64, 4096, 1001)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=["x".join(map(str, s)) for s in FUSED_SHAPES])
def test_cuda_plam_matmul_float_bit_identical(cuda_device, shape, dtype):
    m, k, n = shape
    x = torch.from_numpy(_activations(m, k))
    if dtype == "bf16":
        x = x.to(torch.bfloat16)
    x = x.to(cuda_device)
    w = torch.from_numpy(_ragged_operands((1, k, n))[1]).to(cuda_device)
    for bb in (w, pack16(w)):
        _lib.reset_launches()
        got = plam_matmul_float(x, bb, P16)
        assert _lib.launches["plam_matmul"] == 1 and _lib.launches["posit_codec"] == 0
        want = plam_matmul_float(x, bb, P16, use_kernel=False)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_plam_matmul_float_bf16_off_4_bytes(cuda_device):
    """bf16 rows whose base is 2 bytes past a 4-byte boundary (even K) take
    the guarded 2-byte loads and give the same bits."""
    m, k, n = 4, 4096, 512
    x = torch.from_numpy(_activations(m, k)).to(torch.bfloat16).to(cuda_device)
    buf = torch.empty(m * k + 1, dtype=torch.bfloat16, device=cuda_device)
    x_odd = buf[1:].view(m, k)
    x_odd.copy_(x)
    assert x_odd.is_contiguous() and x_odd.data_ptr() % 4 == 2
    w = pack16(torch.from_numpy(_ragged_operands((1, k, n))[1]).to(cuda_device))
    got = plam_matmul_float(x_odd, w, P16)
    assert torch.equal(got.view(torch.int32), plam_matmul_float(x, w, P16).view(torch.int32))
    want = plam_matmul_float(x, w, P16, use_kernel=False)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_plam_dense_makes_one_launch(cuda_device):
    x = torch.randn((4, 64), device=cuda_device).to(torch.bfloat16)
    w = pack16(torch.from_numpy(_ragged_operands((1, 64, 24))[1]).to(cuda_device))
    _lib.reset_launches()
    ops.plam_dense(x, w, P16)
    assert _lib.launches["plam_matmul"] == 1
    assert sum(_lib.launches.values()) == 1
