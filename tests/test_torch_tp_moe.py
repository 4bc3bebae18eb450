"""Tensor-parallel serving of the MoE family: reduced deepseek-moe-16b (2
shared experts) and granite-moe-1b-a400m (no shared expert, and once
with the full config's vocab of 49,155, which no model axis divides:
embedding and head stay whole) at tp = 2, two ``gloo`` ranks on the CPU
in ONE spawned world, against the JAX engine's tokens at tp = 1.

The reference's default rules cut each expert inside (``moe/(wu|wg)`` on
f, ``moe/wd`` on f, the router whole), so every rank routes the same
tokens to the same experts and the routed and shared experts' partial
sums meet in one reduction.  f32 parameters and activations, weights
from the reference's init through ``params_from_jax``.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving import PagedServeConfig as JPaged  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.launch.serve import serve_jobs  # noqa: E402
from repro_torch.serving import ServeOptions  # noqa: E402

from test_torch_chunked import _numpy_tree  # noqa: E402

TP = 2
POOL = dict(block_size=4, num_blocks=96, max_slots=3, max_seq_len=48)
MODELS = {"deepseek": ("deepseek-moe-16b", {}), "granite": ("granite-moe-1b-a400m", {}),
          "granite-vocab-49155": ("granite-moe-1b-a400m", {"vocab": 49155})}
CASES = {f"{m}-chunk{c}": (m, c) for m in MODELS for c in (0, 4)}


def _cfgs(model):
    arch, over = MODELS[model]
    red = dict(param_dtype="float32", act_dtype="float32", **over)
    return (dataclasses.replace(j_get_config(arch).reduced(), **red).with_numerics("default=f32"),
            dataclasses.replace(t_get_config(arch).reduced(), **red).with_numerics("default=f32"))


def _requests():
    rng = np.random.default_rng(0)
    return [dict(prompt=rng.integers(0, 512, n).tolist(), max_new_tokens=4, arrival_step=i)
            for i, n in enumerate((5, 8, 7))]


_PARAMS = {}


def _params(model):
    if model not in _PARAMS:
        _PARAMS[model] = j_build(_cfgs(model)[0]).init(jax.random.PRNGKey(0))
    return _PARAMS[model]


@pytest.fixture(scope="module")
def served():
    jobs = [dict(cfg=_cfgs(m)[1], params=_numpy_tree(_params(m)), requests=_requests(),
                 opts=ServeOptions(tp=TP, prefill_chunk=c, **POOL))
            for m, c in CASES.values()]
    ranks = spawn(serve_jobs, TP, "cpu", jobs, threads=1, timeout=300)
    return {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (``tests/test_torch_ssm.py::one_thread``)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_tokens(model, chunk):
    """The JAX engine's tokens at tp = 1 with the same chunk width (a MoE
    forward's capacity, and so its drops, depend on its tokens: a chunked
    prefill is another computation, unlike the dense family's)."""
    eng = JEngine(_cfgs(model)[0], params=_params(model),
                  pcfg=JPaged(prefill_chunk=chunk, **POOL))
    hs = [eng.submit(**req) for req in _requests()]
    done = eng.run()
    return [done[h.rid] for h in hs]


@pytest.mark.parametrize("name", list(CASES))
def test_tp2_moe_matches_the_reference_tp1(served, name):
    model, chunk = CASES[name]
    got = served[name]
    assert got[0]["outputs"] == got[1]["outputs"]
    assert got[0]["pool_layout"] == "kv_heads"
    if chunk:
        assert got[0]["stats"]["prefills"] > 3
    assert got[0]["outputs"] == _jax_tokens(model, chunk)
