"""The port's continuous-batching engine serving the MoE family against the
JAX reference engine (the engine features and the CLI on a MoE arch are
in ``tests/test_torch_moe_serve.py``, which imports the helpers here).

Reduced deepseek-moe-16b (2 shared experts) and granite-moe-1b-a400m (no
shared expert) with f32 parameters, weights made by the reference's init
and converted with ``repro_torch.convert.params_from_jax``.  Both engines
serve the same requests on the same weights: identical greedy tokens,
counters and prequantized weights' meta.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import ServeOptions, build_engine  # noqa: E402
from repro_torch.serving.observability import macs_per_token_by_mode  # noqa: E402

from test_torch_chunked import _numpy_tree, serve_both  # noqa: E402

ARCHS = {"deepseek": "deepseek-moe-16b", "granite": "granite-moe-1b-a400m"}
POOL = dict(block_size=4, num_blocks=96, max_slots=3, max_seq_len=48)


def _even(eng):
    """Three requests of 5-8 tokens, one step apart: one padded prefill
    shape, so that the reference compiles its PLAM kernels once."""
    rng = np.random.default_rng(0)
    hs = [eng.submit(rng.integers(0, 512, n).tolist(), max_new_tokens=4, arrival_step=i)
          for i, n in enumerate((5, 8, 7))]
    done = eng.run()
    return [done[h.rid] for h in hs]


@functools.lru_cache(maxsize=None)
def _weights(arch: str, seed: int = 0):
    jc = dataclasses.replace(j_get_config(ARCHS[arch]).reduced(), param_dtype="float32",
                             act_dtype="float32")
    tc = dataclasses.replace(t_get_config(ARCHS[arch]).reduced(), param_dtype="float32",
                             act_dtype="float32")
    jp = j_build(jc).init(jax.random.PRNGKey(seed))
    return jc, jp, tc, params_from_jax(_numpy_tree(jp), tc, device="cpu")


def models(arch: str, policy: str, fresh: bool = False):
    """(jc, jp, tc, tm) under ``policy``.  Every policy shares the weights;
    ``fresh`` converts a model of its own for an engine that prequantizes
    (it encodes the model it is given in place)."""
    jc, jp, tc, tm = _weights(arch)
    if fresh:
        tm = params_from_jax(_numpy_tree(jp), tc, device="cpu")
    return (jc.with_numerics(f"default={policy}"), jp,
            tc.with_numerics(f"default={policy}"), tm)


@pytest.mark.parametrize("policy,prequantize", [("plam_sim:16:1", True),
                                                ("plam_sim:16:1", False), ("f32", False)],
                         ids=["plam-prequantized", "plam", "f32"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_engine_matches_reference(arch, policy, prequantize):
    """Three requests over three slots: tokens, counters and the
    prequantized weights' meta equal the reference's; the router stays f32
    (its site resolves to f32 under the baseline rule)."""
    jeng, teng, _ = serve_both(models(arch, policy, fresh=prequantize), _even,
                               prequantize=prequantize, **POOL)
    assert teng.prequant_meta == jeng.prequant_meta
    assert teng.stats.prefills == jeng.stats.prefills
    router = teng.model.blocks[0].moe.router
    assert router.dtype == torch.float32
    if prequantize:
        assert "layers/moe/router" not in teng.prequant_meta
        assert teng.prequant_meta["layers/moe/wg"]["role"] == "moe.expert.gate"
        assert teng.model.blocks[0].moe.wg.dtype == torch.int16
        if arch == "deepseek":
            assert teng.prequant_meta["layers/moe/shared/wd"]["role"] == "moe.shared.down"


def test_moe_engine_counts_macs_by_mode():
    """serve_macs_total: the experts' MACs under plam_sim, the router's
    under f32, each above 0 once the engine has served."""
    _, _, tc, tm = models("deepseek", "plam_sim:16:1")
    by_mode = macs_per_token_by_mode(tc)
    assert by_mode["plam_sim:16:1"] > 0 and by_mode["f32"] == tc.n_layers * tc.d_model * 4
    eng = build_engine(tc, ServeOptions(**POOL), params=tm, device="cpu")
    eng.submit([1, 2, 3], max_new_tokens=2)
    eng.run()
    prom = eng.metrics.to_prometheus_text()
    for mode in ("plam_sim:16:1", "f32"):
        line = next(ln for ln in prom.splitlines()
                    if ln.startswith(f'serve_macs_total{{mode="{mode}"}}'))
        assert float(line.split()[-1]) > 0


def test_unported_family_still_raises():
    """The MoE family is served, and every other family too: encdec (the
    last one ported) builds on the static engine under engine="auto", and
    the continuous engine refuses it as the reference does (no paged KV
    layout)."""
    from repro_torch.serving import Engine

    cfg = t_get_config("seamless-m4t-medium").reduced()
    assert isinstance(build_engine(cfg, ServeOptions(), device="cpu"), Engine)
    with pytest.raises(ValueError, match="no paged KV layout"):
        build_engine(cfg, ServeOptions(engine="continuous"), device="cpu")

