"""The dry run's cells in the port against the reference's: the four
assigned shapes, every family's step inputs, and the meta-device init.

``applicable_shapes`` and ``shape_by_name`` equal the reference's for
the ten archs; ``train_inputs``, ``prefill_inputs`` and ``decode_inputs``
give the reference's ``ShapeDtypeStruct`` shapes and dtypes key by key at
a CI shape on the reduced configs (``cache_len`` is a host int in the
port, the cache's last slot); ``init(device="meta")`` builds every full
model without a byte of memory, and ``init`` on the CPU draws what a CPU
generator seeded alike draws.
"""
import dataclasses
import resource

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.models import build as ref_build
from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.models import encdec, hybrid, mamba_lm, transformer
from repro_torch.models.registry import build, encdec_tgt_len

from test_torch_ssm import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

KINDS = ("train", "prefill", "decode")
MODEL_CLASSES = {"dense": transformer.DenseLM, "moe": transformer.DenseLM,
                 "vlm": transformer.DenseLM, "ssm": mamba_lm.MambaLM,
                 "hybrid": hybrid.HybridLM, "encdec": encdec.EncDecLM}


def test_shapes_equal_the_reference():
    assert [dataclasses.astuple(s) for s in configs.ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in ref_configs.ALL_SHAPES]
    for s in ref_configs.ALL_SHAPES:
        assert dataclasses.astuple(configs.shape_by_name(s.name)) == dataclasses.astuple(s)
    with pytest.raises(KeyError):
        configs.shape_by_name("nope")
    applicable = 0
    for arch in ref_configs.ARCHS:
        ours = [s.name for s in configs.applicable_shapes(configs.get_config(arch))]
        assert ours == [s.name for s in ref_configs.applicable_shapes(
            ref_configs.get_config(arch))], arch
        applicable += len(ours)
    assert applicable == 32


def _flat(tree, prefix=""):
    """path -> leaf, the paths '/'-joined dict keys and tuple indices."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


@pytest.mark.parametrize("arch", sorted(ref_configs.ARCHS))
@pytest.mark.parametrize("kind", KINDS)
def test_step_inputs_match_the_reference(arch, kind):
    ours = build(configs.get_config(arch).reduced())
    ref = ref_build(ref_configs.get_config(arch).reduced())
    shape = ShapeSpec("ci", 64, 4, kind)
    got = _flat(getattr(ours, f"{kind}_inputs")(shape.global_batch, shape.seq_len))
    want = _flat(getattr(ref, f"{kind}_inputs")(RefShapeSpec("ci", 64, 4, kind)))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        if path == "cache_len":  # a host int: the cache's last slot
            cfg = ours.cfg
            last = encdec_tgt_len(cfg, 64) if cfg.family == "encdec" else 64
            assert got[path] == last - 1 and isinstance(got[path], int)
            assert leaf.shape == () and leaf.dtype == jnp.int32
            continue
        assert got[path].is_meta, path
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        assert str(got[path].dtype).replace("torch.", "") == str(jnp.dtype(leaf.dtype)), path


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_meta_init_allocates_nothing(arch):
    """The full model as ``init`` gives it, on meta: every parameter a
    meta tensor of the reference's count, and the process no larger."""
    cfg = configs.get_config(arch)
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    model = build(cfg).init(0, device="meta")
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before) * 1024
    params = list(model.parameters())
    assert params and all(p.is_meta for p in (*params, *model.buffers()))
    ref_cfg = ref_configs.get_config(arch)
    ref_api = ref_build(ref_cfg)
    ref_tree = jax.eval_shape(lambda: ref_api.init(jax.random.PRNGKey(0)))
    ref_n = sum(leaf.size for leaf in jax.tree_util.tree_leaves(ref_tree))
    n = sum(p.numel() for p in params)
    assert n == ref_n
    # ru_maxrss is in KiB: a real model would add at least 2 bytes a parameter
    assert grown < min(n * 2, 1 << 30) // 4


@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-moe-16b", "mamba2-780m", "zamba2-1.2b",
                                  "seamless-m4t-medium", "qwen2-vl-72b"])
def test_cpu_init_draws_as_before(arch):
    """``init`` on the CPU: the values of the model class drawn from a CPU
    generator seeded alike (the init's generator before the meta device
    had one), parameter for parameter, and the meta model's shapes."""
    cfg = configs.get_config(arch).reduced()
    model = build(cfg).init(3, device="cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    want = MODEL_CLASSES[cfg.family](cfg, generator=gen, device=torch.device("cpu"))
    got = dict(model.named_parameters())
    for name, p in want.named_parameters():
        assert torch.equal(got[name], p), name
    meta = dict(build(cfg).init(3, device="meta").named_parameters())
    assert {n: (tuple(p.shape), p.dtype) for n, p in meta.items()} == \
        {n: (tuple(p.shape), p.dtype) for n, p in got.items()}
