"""The port's vlm family (the qwen2-vl-72b backbone: M-RoPE and a prefix of
patch embeddings) against the JAX reference.

``apply_rope`` with M-RoPE sections over three distinct position rows:
each section of the half-dim frequencies is, bit for bit, the plain
rotary embedding at its own row (so a wrong split shows, where equal
rows would hide it), and the whole is within 5e-7 of the reference's
(torch's and XLA's cos and sin differ by an f32 ulp in some lanes).  At
the reduced size with f32 parameters and activations, the port's seeded
init carried to the reference with ``params_to_jax``: the backbone over
a seeded patch prefix and tokens with f32 caches within 1e-5, and the
static engine's greedy tokens, every forward's logits (within 2e-3 of
the call's largest |logit|: the engine keeps K/V in bf16), its first
decode position (patches + tokens) and ``ServeStats`` (``prefill_tokens``
counts the patches) against the reference ``Engine``, under f32 and
under ``plam_sim:16:1`` with prequantized weights (the reference's
engine on the same int16 patterns).
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.prequant import quantize_params as t_quantize  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.serving import Engine, ServeConfig, ServeOptions, build_engine  # noqa: E402

from test_torch_dense_archs import _capture, _serve, check_logits  # noqa: E402
from test_torch_ssm import one_thread  # noqa: E402,F401
from test_torch_train_loss import assert_trains  # noqa: E402

ARCH = "qwen2-vl-72b"
PLAM = "plam_sim:16:1"
F32_TOL = 1e-5
ROPE_TOL = 5e-7
rng = np.random.default_rng(8)
TOKENS = rng.integers(0, 512, (2, 6)).astype(np.int32)
PATCHES = rng.standard_normal((2, 16, 128)).astype(np.float32)  # the reduced 16 patches
NEW = 4
STATS = ("steps", "prefills", "prefill_tokens", "decode_steps", "active_slot_steps",
         "generated_tokens")

pytestmark = pytest.mark.usefixtures("one_thread")


def _cfgs(policy="f32"):
    j = dataclasses.replace(j_get_config(ARCH).reduced(), param_dtype="float32",
                            act_dtype="float32")
    t = dataclasses.replace(t_get_config(ARCH).reduced(), param_dtype="float32",
                            act_dtype="float32")
    return j.with_numerics(f"default={policy}"), t.with_numerics(f"default={policy}")


@functools.lru_cache(maxsize=None)
def weights(policy="f32"):
    """The port's seeded f32 init as the reference's tree of numpy arrays,
    under plam_sim with the port's int16 patterns (the reference's own)."""
    _, tc = _cfgs(policy)
    model = t_build(tc).init(seed=0, device="cpu")
    return params_to_jax(t_quantize(tc, model)[0] if policy == PLAM else model)


def test_apply_rope_sections_on_distinct_rows():
    sections, theta = (4, 6, 6), 1e6
    g = np.random.default_rng(9)
    x = g.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = np.stack([g.integers(0, 4000, (2, 5)) for _ in range(3)]).astype(np.int32)
    assert len({tuple(r.ravel()) for r in pos}) == 3  # three distinct rows
    got = t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, sections)
    # section i of the 16 half-dim frequencies (and its mirror in the
    # second half) turns by row i, exactly as the plain embedding at row i
    start = 0
    for i, sec in enumerate(sections):
        plain = t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[i]), theta)
        for lo in (start, 16 + start):
            assert torch.equal(got[..., lo:lo + sec], plain[..., lo:lo + sec])
        start += sec
    want = np.asarray(j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, sections))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROPE_TOL)
    # equal rows (text-only positions) are the plain embedding, bit for bit
    same = t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[:1]).expand(3, 2, 5),
                               theta, sections)
    assert torch.equal(same, t_common.apply_rope(torch.from_numpy(x),
                                                 torch.from_numpy(pos[0]), theta))
    with pytest.raises(ValueError, match="sections"):
        t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, (4, 6, 5))


def test_mrope_positions_match_reference():
    lengths = np.array([3, 0, 7], np.int32)
    want = j_common.multi_token_positions(jnp.asarray(lengths), 4, mrope=True)
    got = t_common.multi_token_positions(torch.from_numpy(lengths), 4, mrope=True)
    assert got.shape == (3, 3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        t_common.decode_positions(torch.from_numpy(lengths), mrope=True).numpy(),
        np.asarray(j_common.decode_positions(jnp.asarray(lengths), mrope=True)))
    jc, tc = _cfgs()
    np.testing.assert_array_equal(t_tf.default_positions(tc, 2, 5, offset=3).numpy(),
                                  np.asarray(j_tf.default_positions(jc, 2, 5, offset=3)))


def test_vlm_backbone_with_patch_prefix_matches_reference():
    """The patch embeddings ahead of the token embeddings through the
    backbone with f32 caches of P + S positions, then the last logits."""
    jc, tc = _cfgs()
    jp = jax.tree.map(jnp.asarray, weights())
    tm = params_from_jax(weights(), tc, device="cpu")
    b, s = TOKENS.shape
    p = PATCHES.shape[1]
    assert t_registry.vlm_patches(tc) == p
    jx = jnp.concatenate([jnp.asarray(PATCHES), j_tf.embed_tokens(jc, jp, jnp.asarray(TOKENS))],
                         axis=1)
    jh, _ = j_tf.lm_backbone(jc, jp, jx, j_tf.default_positions(jc, b, p + s),
                             kv_caches=j_tf.kv_cache_init(jc, b, p + s, jnp.float32),
                             cache_len=jnp.int32(0))
    want = j_tf.lm_logits(jc, jp, jh[:, -1:])
    tx = torch.cat([torch.from_numpy(PATCHES), t_tf.embed_tokens(tc, tm, torch.from_numpy(TOKENS))],
                   dim=1)
    th, _ = t_tf.lm_backbone(tc, tm, tx, t_tf.default_positions(tc, b, p + s),
                             kv_caches=t_tf.kv_cache_init(tc, b, p + s, torch.float32, "cpu"),
                             cache_len=0)
    got = t_tf.lm_logits(tc, tm, th[:, -1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=F32_TOL)
    meta = t_build(tc).prefill_inputs(2, 40)
    assert meta["tokens"].shape == (2, 24) and meta["embeds_prefix"].shape == (2, 16, 128)


@functools.lru_cache(maxsize=None)
def reference_run(policy):
    """The reference static engine's tokens, per-forward logits, decode
    positions and stats (on int16 patterns under plam_sim)."""
    jc, _ = _cfgs(policy)
    eng = JEngine(jc, params=jax.tree.map(jnp.asarray, weights(policy)))
    logits, positions = [], []
    decode = eng._decode

    def decode_at(params, batch):
        positions.append(int(batch["cache_len"]))
        return decode(params, batch)

    eng._prefill, eng._decode = _capture(eng._prefill, logits), _capture(decode_at, logits)
    out = eng.generate({"tokens": jnp.asarray(TOKENS), "embeds_prefix": jnp.asarray(PATCHES)},
                       JServeConfig(max_new_tokens=NEW))
    stats = {f: getattr(eng.stats, f) for f in STATS}
    return np.asarray(out).tolist(), logits, positions, stats


@pytest.mark.parametrize("policy", ["f32", PLAM])
def test_static_engine_matches_reference(policy):
    want, want_logits, want_positions, stats = reference_run(policy)
    _, tc = _cfgs(policy)
    _lib.reset_launches()
    logits, positions = [], []
    eng = _serve(build_engine(tc, ServeOptions(prequantize=policy == PLAM),
                              params=params_from_jax(weights(), tc, device="cpu"), device="cpu"),
                 ("prefill",), logits)
    assert isinstance(eng, Engine)
    decode = eng.api.decode_step

    def decode_at(model, batch, use_kernel=None):
        positions.append(batch["cache_len"])
        return decode(model, batch, use_kernel=use_kernel)

    eng.api = dataclasses.replace(eng.api, decode_step=_capture(decode_at, logits))
    out = eng.generate({"tokens": TOKENS, "embeds_prefix": PATCHES},
                       ServeConfig(max_new_tokens=NEW))
    assert out.tolist() == want
    check_logits(logits, want_logits)
    p_s = PATCHES.shape[1] + TOKENS.shape[1]
    assert positions == want_positions == list(range(p_s, p_s + NEW - 1))
    assert {f: getattr(eng.stats, f) for f in STATS} == stats
    assert eng.stats.prefill_tokens == TOKENS.shape[0] * p_s
    assert bool(eng.prequant_meta) == (policy == PLAM)
    assert all(v == 0 for v in _lib.launches.values())  # CPU: plain versions only


def test_vlm_has_no_paged_layout_and_does_not_train():
    """As in the reference: the continuous engine refuses the vlm family.
    It trains now (the name is older than that): one AdamW step on a
    batch with its patch prefix gives a finite loss and a gradient on
    every float leaf."""
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="no paged KV layout"):
        build_engine(tc, ServeOptions(engine="continuous"), device="cpu")
    api = t_build(tc)
    assert_trains(api, api.init(device="cpu"), {"tokens": TOKENS, "labels": TOKENS,
                                                 "embeds_prefix": PATCHES})
