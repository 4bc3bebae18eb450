"""Tensor-parallel serving with the engine's features: n-gram
speculative decoding, recompute preemption and the prefix cache at
tp = 2 (two ``gloo`` ranks on the CPU, ONE spawned world for the file)
against the JAX engine's tokens at tp = 1, mirroring the reference's
``test_tp2_{spec,preempted,prefix_cache}_*_forced_devices`` scripts
(the cases and helpers are ``tests/test_torch_tp_serving.py``'s).
"""
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from test_torch_tp_serving import jax_tokens, same_on_both_ranks, serve_cases  # noqa: E402

NAMES = ["spec-chunk0-k2", "spec-chunk8-k4", "preempt-chunk0-k0", "preempt-chunk4-k2",
         "prefix-chunk0-k0", "prefix-chunk4-k2"]


@pytest.fixture(scope="module")
def served():
    return serve_cases(NAMES)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (``tests/test_torch_ssm.py::one_thread``)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", ["spec-chunk0-k2", "spec-chunk8-k4"])
def test_tp2_spec_decoding_matches_the_reference_tp1(served, name):
    res = same_on_both_ranks(served[name])
    assert res["stats"]["spec_steps"] > 0
    assert res["outputs"] == jax_tokens(name)


@pytest.mark.parametrize("name", ["preempt-chunk0-k0", "preempt-chunk4-k2"])
def test_tp2_preempted_matches_the_reference_tp1(served, name):
    """A pressure pool at tp = 2 preempts and resumes; the tokens are
    the uninterrupted tp = 1 run's and every block comes back."""
    res = same_on_both_ranks(served[name])
    assert res["stats"]["preemptions"] > 0 and res["cache"]["num_free"] == 7
    assert res["outputs"] == jax_tokens(name)


@pytest.mark.parametrize("name", ["prefix-chunk0-k0", "prefix-chunk4-k2"])
def test_tp2_prefix_cache_matches_the_reference_tp1(served, name):
    """Shared-prefix requests with the prefix cache on at tp = 2 give the
    tp = 1 reference's tokens (its cache off)."""
    res = same_on_both_ranks(served[name])
    assert res["cache"]["hits"] > 0
    assert res["outputs"] == jax_tokens(name)
