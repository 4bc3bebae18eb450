"""The op-level analysis (``launch/op_analysis.py``) against the
reference's HLO analysis and hand counts.

The programs of ``tests/test_hlo_analysis.py``, written in torch, give
the FLOPs of the reference's ``analyze`` exactly (eager loops run every
iteration, so no trip-count correction is needed); element ops, bytes
and views are hand counted; a kernel launch on meta tensors is counted
with its hand-counted work and runs nothing, and the wrappers still take
the plain versions on CPU tensors.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import analyze
from repro_torch.kernels import _lib, ops, posit_codec
from repro_torch.kernels.ref import plam_matmul_seqref
from repro_torch.launch.op_analysis import OpAnalysis, top_contributors
from repro_torch.numerics import P16

from test_torch_ssm import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
da = importlib.import_module("repro_torch.kernels.decode_attention")


@pytest.fixture(autouse=True)
def launches_restored():
    """The meta launches a test here counts are taken back after it: the
    port's other tests, which may share this process, hold the counters
    at 0 on the CPU."""
    before = dict(_lib.launches)
    yield
    _lib.launches.update(before)


def _ref_flops(f, *shapes):
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze(jax.jit(f).lower(*specs).compile().as_text()).flops


def _ours(f, *shapes):
    args = [torch.empty(s, device="meta") for s in shapes]
    with OpAnalysis() as oa:
        out = f(*args)  # noqa: F841 - what the step returns is alive at its end
    return oa.result


def _loop(n):
    def jf(x, w):
        def body(c_, _):
            return jnp.tanh(c_ @ w), None
        return jax.lax.scan(body, x, None, length=n)[0]

    def tf(x, w):
        for _ in range(n):
            x = torch.tanh(x @ w)
        return x
    return jf, tf


def test_loopfree_matmul():
    got = _ours(lambda x, w: torch.tanh(x @ w), (512, 512), (512, 512))
    assert got.flops == _ref_flops(lambda x, w: jnp.tanh(x @ w), (512, 512), (512, 512)) \
        == 2 * 512 ** 3
    assert dict(got.flops_by_class) == {"f32": 2 * 512 ** 3}


@pytest.mark.parametrize("n", [4, 8])
def test_loop_flops_scale_with_trips(n):
    jf, tf = _loop(n)
    assert _ours(tf, (256, 256), (256, 256)).flops == \
        _ref_flops(jf, (256, 256), (256, 256)) == n * 2 * 256 ** 3


def test_nested_loops_compose():
    def jf(x, w):
        def inner(c_, _):
            return c_ @ w, None

        def outer(c_, _):
            return jax.lax.scan(inner, c_, None, length=3)[0], None
        return jax.lax.scan(outer, x, None, length=4)[0]

    def tf(x, w):
        for _ in range(4):
            for _ in range(3):
                x = x @ w
        return x

    assert _ours(tf, (128, 128), (128, 128)).flops == \
        _ref_flops(jf, (128, 128), (128, 128)) == 12 * 2 * 128 ** 3


def test_conv_flops():
    def jf(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def tf(x, w):  # NCHW and OIHW: the same convolution
        return torch.nn.functional.conv2d(x, w, padding=1)

    want = _ref_flops(jf, (2, 16, 16, 8), (3, 3, 8, 16))
    assert _ours(tf, (2, 8, 16, 16), (16, 8, 3, 3)).flops == want == \
        2 * (2 * 16 * 16 * 16) * (3 * 3 * 8)


def test_bf16_and_tf32_classes(monkeypatch):
    with OpAnalysis() as oa:
        torch.empty((64, 32), dtype=torch.bfloat16, device="meta") @ \
            torch.empty((32, 16), dtype=torch.bfloat16, device="meta")
    assert dict(oa.result.flops_by_class) == {"bf16": 2 * 64 * 32 * 16}
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    got = _ours(lambda x, w: x @ w, (64, 32), (32, 16))
    assert dict(got.flops_by_class) == {"tf32": 2 * 64 * 32 * 16}


def test_elem_ops_counted():
    got = _ours(lambda x: torch.tanh(x) * 2.0, (128, 128))
    assert got.elem_ops >= 128 * 128
    assert got.elem_ops == 2 * 128 * 128  # tanh, then mul: eager ops do not fuse


def test_bytes_by_hand_and_views_free():
    n = 128 * 128 * 4
    assert _ours(lambda x: x * 2.0, (128, 128)).hbm_bytes == 2 * n  # read, write
    assert _ours(lambda x, y: x + y, (128, 128), (128, 128)).hbm_bytes == 3 * n
    views = _ours(lambda x: x.view(64, 256).t().unsqueeze(0)[0, :3].expand(2, 3, 64),
                  (128, 128))
    assert views.hbm_bytes == 0 and views.elem_ops == 0 and views.ops == []
    # a reshape that cannot be a view copies
    copied = _ours(lambda x: x.t()[:3].reshape(-1), (128, 128))
    assert copied.hbm_bytes == 2 * 3 * 128 * 4
    # a copy reads its source and writes its destination
    assert _ours(lambda x, y: x.copy_(y), (128, 128), (128, 128)).hbm_bytes == 2 * n
    # a broadcast operand is read once
    assert _ours(lambda x, b: x + b, (128, 128), (1, 128)).hbm_bytes == 2 * n + 128 * 4
    # a gather reads and writes its rows (and reads its indices)
    with OpAnalysis() as oa:
        table = torch.empty((1000, 64), device="meta")
        idx = torch.empty((10,), dtype=torch.int64, device="meta")
        table[idx]
    assert oa.result.hbm_bytes == 2 * 10 * 64 * 4 + 10 * 8


def test_live_bytes_follow_frees():
    """The peak of the storages a step makes, freed ones subtracted."""
    def step(x):
        for _ in range(5):
            a = x * 2.0
            b = a + 1.0
            del a, b
        return x * 3.0

    got = _ours(step, (1000, 1000))
    assert got.peak_live_bytes == 2 * 4e6  # a and b at once
    assert got.end_live_bytes == 4e6  # the result


def test_top_contributors():
    got = _ours(lambda x, w: torch.tanh(x @ w) @ w, (64, 64), (64, 64))
    flops = top_contributors(got, key="flops")
    assert flops == [(2 * 2 * 64 ** 3, "mm", str([[64, 64], [64, 64]]), 2)]
    assert top_contributors(got, key="collective") == []
    assert top_contributors(got, key="bytes")[0][0] > 0


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def no_library(monkeypatch):
    """A launch on meta tensors loads no library and calls no nvcc."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_lib, "library", refuse)
    monkeypatch.setattr(_lib, "build", refuse)


def test_meta_k1_launches_are_counted_with_their_work(no_library):
    m, k, n, e = 4, 64, 48, 3
    before = dict(_lib.launches)
    with OpAnalysis() as oa:
        out2 = ops.plam_dense(_meta((m, k), torch.bfloat16), _meta((k, n), torch.int16))
        out3 = ops.plam_dense(_meta((e, m, k), torch.float32), _meta((e, k, n), torch.int16))
    assert out2.is_meta and tuple(out2.shape) == (m, n) and out2.dtype == torch.float32
    assert out3.is_meta and tuple(out3.shape) == (e, m, n)
    assert _lib.launches["plam_matmul"] - before["plam_matmul"] == 2
    assert _lib.launches["plam_matmul_grouped"] - before["plam_matmul_grouped"] == 1
    work = oa.result.kernels["plam_matmul"]
    assert work["launches"] == 2
    assert work["int_ops"] == m * n * k + e * m * n * k  # one add a product
    assert work["bytes"] == (m * k * 2 + k * n * 2 + m * n * 4) + \
        e * (m * k * 4 + k * n * 2 + m * n * 4)
    assert oa.result.int_ops == work["int_ops"] and oa.result.flops == 0


def test_meta_k3_and_k2_launches_are_counted_with_their_work(no_library):
    x = _meta((2048, 1024), torch.bfloat16)  # 2^21 lanes: the table path
    before = dict(_lib.launches)
    with OpAnalysis() as oa:
        posit_codec.posit_quantize(x, P16)
        posit_codec.posit_encode(x[:4], P16, out_dtype=torch.int16)
        posit_codec.posit_decode(_meta((4, 1024), torch.int16), P16)
    counted = {k: v - before[k] for k, v in _lib.launches.items() if v != before[k]}
    assert counted.pop("posit_codec") == 3
    assert set(counted) <= {"posit_codec_quant_table"}  # built once per process
    work = oa.result.kernels["posit_codec"]
    lanes = 2048 * 1024 + 2 * 4 * 1024
    assert work["int_ops"] == lanes  # one operation a lane
    assert work["bytes"] == 2048 * 1024 * (2 + 4) + 4 * 1024 * (2 + 2) + 4 * 1024 * (2 + 4)

    b, h, kv, hd, bs, max_blk = 4, 32, 4, 128, 16, 8
    q = _meta((b, h, hd), torch.bfloat16)
    pool = _meta((64, bs, kv, hd), torch.bfloat16)
    with OpAnalysis() as oa:
        out = da.paged_decode_attention(q, pool, pool, _meta((b, max_blk), torch.int32),
                                        _meta((b,), torch.int32))
    assert out.is_meta and out.shape == q.shape
    work = oa.result.kernels["paged_decode_attention"]
    keys = max_blk * bs  # every key the table rows name
    assert work["launches"] == 1
    assert work["flops"] == 2 * 2 * b * h * keys * hd  # Q.K^T and P.V, 2 a multiply-add
    assert work["bytes"] == 2 * b * h * hd * 2 + 2 * b * keys * kv * hd * 2 + (b * max_blk + b) * 4
    assert oa.result.flops_by_class["f32"] == work["flops"]


def test_meta_k4_launches_count_their_alu_operations(no_library):
    a = _meta((1000,), torch.int32)
    with OpAnalysis() as oa:
        ops.plam_mul_elementwise(a, a, P16)
        ops.exact_mul_elementwise(a, a, P16)
    work = oa.result.kernels["posit_mul"]
    # csrc/posit_mul.cu's hand counts: 72 and 75 ALU operations a lane
    assert work["launches"] == 2 and work["int_ops"] == (72 + 75) * 1000
    assert work["bytes"] == 2 * 3 * 1000 * 4


def test_cpu_wrappers_still_take_the_plain_versions(monkeypatch):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    w_bits = posit_codec.posit_encode(
        torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32)), P16,
        out_dtype=torch.int16)
    before = dict(_lib.launches)
    got = ops.plam_dense(x, w_bits, P16)
    assert torch.equal(got, plam_matmul_seqref(posit_codec.posit_encode(x, P16), w_bits, P16))
    assert dict(_lib.launches) == before
    with pytest.raises(ValueError):
        ops.plam_dense(x, w_bits, P16, use_kernel=True)
    with pytest.raises(ValueError):
        _lib.require(x, "x", (torch.float32,))
    heard = []
    monkeypatch.setattr(_lib, "listeners", [lambda name, work: heard.append(name)])
    ops.posit_quantize(x, P16)
    assert heard == [] and dict(_lib.launches) == before
    # meta takes the kernel's path, and use_kernel=False the plain one anywhere
    assert _lib.wants_kernel(x.to("meta"), None)
    assert not _lib.wants_kernel(x.to("meta"), False)
