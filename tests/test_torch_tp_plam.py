"""Tensor-parallel serving under the card's numerics: reduced yi-6b under
``plam_sim:16:1`` at tp = 2 (two ``gloo`` ranks on the CPU, ONE spawned
world for the file), each rank encoding its slice of the weights to
int16 patterns after the cut (``quantize_params`` after ``shard_model``),
with chunked prefill, against the JAX engine's tokens at tp = 1 with its
weights prequantized (the case and helpers are
``tests/test_torch_tp_serving.py``'s).
"""
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from test_torch_tp_serving import jax_tokens, same_on_both_ranks, serve_cases  # noqa: E402


@pytest.fixture(scope="module")
def served():
    return serve_cases(["yi-plam-prequantized"])


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (``tests/test_torch_ssm.py::one_thread``)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_tp2_plam_prequantized_matches_the_reference_tp1(served):
    res = same_on_both_ranks(served["yi-plam-prequantized"])
    assert res["pool_layout"] == "kv_heads" and res["kv_heads"] == 1
    assert res["outputs"] == jax_tokens("yi-plam-prequantized")
