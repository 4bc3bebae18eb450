"""``chip_smoke.py``'s launch-count helper against the calls one forward
really makes, on the CPU.

For the reduced config of one model of every family (yi-6b, the three
other dense archs, seamless-m4t-medium, qwen2-vl-72b, deepseek-moe-16b,
mamba2-780m and zamba2-1.2b) under ``default=plam_sim:16:1``, the calls
of ``kernels.ops.plam_dense`` (K1's wrapper) and of the codec's encode
(K3's) are counted at build (``quantize_params``), over one prefill and
one decode step, with int16 prequantized weights and with float weights
encoded every forward; the counts are ``chip_smoke.launch_counts``'s.
On the card each call is one launch.  Also: the static engine runs an
encdec's encoder twice a generate (its prefill's and the encoder output
it keeps for the decode steps), as the reference's does.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.prequant import quantize_params
from repro_torch.kernels import ops, posit_codec
from repro_torch.models import build
from repro_torch.serving import Engine, ServeConfig

from test_torch_ssm import one_thread  # noqa: F401

ARCHS = ("yi-6b", "gemma-7b", "minitron-8b", "command-r-plus-104b", "seamless-m4t-medium",
         "qwen2-vl-72b", "deepseek-moe-16b", "mamba2-780m", "zamba2-1.2b")

pytestmark = pytest.mark.usefixtures("one_thread")


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def counted(monkeypatch):
    """Calls of K1's and K3's wrappers while the test runs."""
    calls = {"k1": 0, "k3": 0}

    def wrap(mod, name, key):
        real = getattr(mod, name)

        def call(*args, **kw):
            calls[key] += 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, call)

    wrap(ops, "plam_dense", "k1")
    wrap(ops, "posit_encode", "k3")  # core.modes' per-forward weight encode
    wrap(posit_codec, "posit_encode", "k3")  # quantize_params' encode at build
    return calls


def _batch(cfg, rng):
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["embeds_prefix"] = torch.from_numpy(
            rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, 7, cfg.frontend_dim)).astype(np.float32))
    return batch


@pytest.mark.parametrize("prequantized", [True, False], ids=["int16", "float"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launch_counts_match_one_forward(arch, prequantized, counted):
    want = _chip_smoke().launch_counts(
        get_config(arch).reduced().with_numerics("default=plam_sim:16:1"), prequantized)
    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype="float32",
                              act_dtype="float32").with_numerics("default=plam_sim:16:1")
    api = build(cfg)
    model = api.init(seed=0, device="cpu")
    if prequantized:
        quantize_params(cfg, model)
        assert counted == {"k1": 0, "k3": want["build"]}
    batch = _batch(cfg, np.random.default_rng(0))
    counted.update(k1=0, k3=0)
    logits, caches = api.prefill(model, batch)
    assert counted == {"k1": want["k1"] + want["enc_k1"], "k3": want["k3"] + want["enc_k3"]}
    counted.update(k1=0, k3=0)
    step = {"token": logits.argmax(-1).to(torch.int32), "cache_len": 4}
    if cfg.family == "encdec":
        from repro_torch.models import encdec

        step.update(kv_caches=caches, enc_out=encdec.encode(cfg, model, batch["frames"]))
        counted.update(k1=0, k3=0)
    else:
        step["kv_caches" if cfg.family in ("dense", "moe", "vlm") else "caches"] = caches
    api.decode_step(model, step)
    assert counted == {"k1": want["k1"], "k3": want["k3"]}


def test_static_engine_encodes_an_encdec_prompt_twice(counted):
    cfg = dataclasses.replace(get_config("seamless-m4t-medium").reduced(),
                              param_dtype="float32", act_dtype="float32")
    cfg = cfg.with_numerics("default=plam_sim:16:1")
    want = _chip_smoke().launch_counts(cfg)
    assert want["enc_k1"] == 1 + 2 * 6 and want["k1"] == 2 * 10 + 1
    full = _chip_smoke().launch_counts(get_config("seamless-m4t-medium"))
    assert (full["enc_k1"], full["k1"], full["build"]) == (73, 121, 194)
    eng = Engine(cfg, prequantize=True, device="cpu")
    counted.update(k1=0, k3=0)
    eng.generate(_batch(cfg, np.random.default_rng(1)), ServeConfig(max_new_tokens=3))
    assert counted == {"k1": 2 * want["enc_k1"] + 3 * want["k1"], "k3": 0}
