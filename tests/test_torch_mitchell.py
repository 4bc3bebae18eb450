"""The ``mitchell_f32`` numerics mode against the JAX reference: ``nmatmul``
at ragged K (the zero padding of the last K-chunk), over f32 and bf16
activations and over prequantized posit patterns, and the port's engine
serving reduced yi-6b under ``default=mitchell_f32``.

Both sides add the same Mitchell products chunk by chunk in f32, in
another order within a chunk (XLA vs torch): they agree to f32 rounding.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.modes import NumericsConfig as JCfg  # noqa: E402
from repro.core.modes import nmatmul as j_nmatmul  # noqa: E402
from repro.numerics import PositSpec as JSpec  # noqa: E402
from repro.numerics import encode as j_encode  # noqa: E402
from repro_torch.core.modes import NumericsConfig as TCfg  # noqa: E402
from repro_torch.core.modes import nmatmul  # noqa: E402
from repro_torch.numerics import pack16  # noqa: E402

from test_torch_chunked import models, serve_both  # noqa: E402
from test_torch_engine import _prompts  # noqa: E402

RTOL = ATOL = 1e-5


@pytest.mark.parametrize("k", [40, 64, 100, 200], ids=lambda k: f"K{k}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("patterns", [False, True], ids=["float-w", "int16-w"])
def test_nmatmul_mitchell_matches_reference(k, dtype, patterns):
    """K below, at and past the 64-wide chunk (padded), f32 and bf16
    activations, float weights and int16 posit patterns (decoded, then
    multiplied as the reference does)."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    x[0, 0, :4] = 0.0  # zero operands give +0.0 products
    w = (rng.standard_normal((k, 9)) * k ** -0.5).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    if patterns:
        w = np.asarray(pack16(torch.from_numpy(np.array(j_encode(jnp.asarray(w),
                                                                   JSpec(16, 1))))))
    want = j_nmatmul(jx, jnp.asarray(w), JCfg(mode="mitchell_f32"), out_dtype=jnp.float32)
    got = nmatmul(tx, torch.from_numpy(w), TCfg(mode="mitchell_f32"), out_dtype=torch.float32)
    assert got.shape == (2, 3, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_nmatmul_mitchell_chunk_is_a_config_field():
    """A narrower plam_chunk regroups the f32 sums, as in the reference."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 50)).astype(np.float32)
    w = rng.standard_normal((50, 6)).astype(np.float32)
    want = j_nmatmul(jnp.asarray(x), jnp.asarray(w), JCfg(mode="mitchell_f32", plam_chunk=16))
    got = nmatmul(torch.from_numpy(x), torch.from_numpy(w),
                  TCfg(mode="mitchell_f32", plam_chunk=16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_engine_mitchell_tokens_match_reference():
    """Reduced yi-6b under default=mitchell_f32: the port's engine gives the
    JAX engine's greedy tokens and counters."""
    def workload(eng):
        hs = [eng.submit(p, max_new_tokens=4, arrival_step=i)
              for i, p in enumerate(_prompts(512))]
        done = eng.run()
        return [done[h.rid] for h in hs]

    serve_both(models("mitchell_f32"), workload, block_size=8, num_blocks=32, max_slots=2,
               max_seq_len=32)
