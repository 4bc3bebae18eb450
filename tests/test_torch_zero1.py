"""ZeRO-1 and the training step's pieces under a mesh, without a world:
the port's ZeRO-1 dims (``optim/optimizers.py::zero1_dims``) against the
reference's ``_zero1_dims`` on every leaf of every shipped config, the
bytes of AdamW state a rank holds (``Zero1``) against that layout's
per-device count, the autograd collectives' identities and transposes
(``parallel/sharding.py``), the loss's normaliser over the data axis and
the gradient norm over shards.

A mesh here is ``Mesh(rank, model, data=...)`` with no process group
(the rules, slices and counts read only its shape and rank), or a
stand-in whose collectives add what the other ranks would send.  The
spawned world is ``tests/test_torch_tp_train.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.optim import optimizers as j_opt  # noqa: E402
from repro.parallel import sharding as j_sh  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.optim.optimizers import (  # noqa: E402
    OptConfig,
    Zero1,
    global_norm,
    init_state,
    zero1_dims,
    zero1_numel,
)
from repro_torch.parallel import sharding as t_sh  # noqa: E402

MESHES = ((1, 2), (2, 1), (2, 2), (2, 4), (16, 16))  # (data, model)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (``tests/test_torch_ssm.py::one_thread``)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _StandIn:
    """What the reference's ``_zero1_dims`` reads of a jax Mesh."""

    def __init__(self, data, model):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    """(path, shape) of every leaf of the reference's init of the shipped
    config, under ``jax.eval_shape`` (stacked layers included)."""
    tree = jax.eval_shape(lambda: j_build(j_get_config(arch)).init(jax.random.PRNGKey(0)))
    return [(j_sh._path_str(path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("data,model", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_zero1_dims_match_the_reference(arch, data, model):
    """Every leaf of every shipped config, at five (data, model) meshes:
    the port's dims are the reference's ``_zero1_dims``, under both rule
    sets."""
    mesh = t_sh.Mesh(0, model, data=data)
    for path, leaf in _ref_leaves(arch):
        for t_rules, j_rules in ((None, None),
                                 (t_sh.expert_parallel_rules(), j_sh.expert_parallel_rules())):
            assert (zero1_dims(path, leaf.shape, mesh, t_rules)
                    == j_opt._zero1_dims(path, leaf, _StandIn(data, model), j_rules)), path


def _kv_excess(cfg, path, tp):
    """The port's kept wk/wv columns over the reference's per-device
    columns (kv_heads_for_rank's replicated heads), 1 elsewhere."""
    if not path.endswith(("attn/wk", "attn/wv")):
        return 1
    held = len(t_sh.kv_heads_for_rank(cfg.n_heads, cfg.n_kv, tp, 0)) * cfg.hd
    whole = cfg.n_kv * cfg.hd
    return held / (whole / tp if whole % tp == 0 else whole)


TRAINED = ("yi-6b", "gemma-7b", "minitron-8b", "command-r-plus-104b", "deepseek-moe-16b",
           "granite-moe-1b-a400m")


@pytest.mark.parametrize("data,model", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch", TRAINED)
def test_rank_state_bytes_are_the_zero1_layouts(arch, data, model):
    """A rank's AdamW m and v (the first and the last rank of the mesh,
    the model cut by ``sharded_init`` on the meta device) hold, leaf by
    leaf, the per-device elements of the reference's ZeRO-1 layout; wk
    and wv where kv < tp hold the whole heads a rank keeps
    (``kv_heads_for_rank``), that many times more."""
    cfg = t_get_config(arch)
    j_cfg = j_get_config(arch)
    if cfg.n_heads % model:
        pytest.skip(f"{cfg.n_heads} heads do not divide tp={model}")
    ref = {path: leaf for path, leaf in _ref_leaves(arch)}
    for rank in (0, data * model - 1):
        mesh = t_sh.Mesh(rank, model, data=data)
        zero = Zero1(t_sh.leaf_layouts(cfg, mesh), mesh)
        model_ = t_tf.lm_init(cfg, device="meta", mesh=mesh)
        state = init_state(OptConfig(), model_, zero)
        held = {}
        for name, t in state["m"].items():
            path = zero.layouts[name].path
            held[path] = held.get(path, 0) + t.numel() + state["v"][name].numel()
        for path, leaf in ref.items():
            want = 2 * zero1_numel(leaf.shape, j_opt._zero1_dims(path, leaf, _StandIn(data, model)),
                                   _StandIn(data, model))
            assert held[path] == want * _kv_excess(j_cfg, path, model), (path, rank)


class _Fake:
    """A mesh stand-in for one rank: its collectives add what ``others``
    (a function of the axis and the tensor) says the other ranks send."""

    axis_names = ("data", "model")
    batch_axis = "data"

    def __init__(self, model_rank=0, model=2, data=1, others=None):
        self.model_rank, self.model_size, self.data_size = model_rank, model, data
        self.batch_size, self.batch_rank = data, 0
        self.shape = {"data": data, "model": model}
        self.others = others or (lambda axis, x: x)

    def all_reduce(self, x, axis="model", op="sum"):
        return x + self.others(axis, x)

    def all_gather(self, x, axis="model"):
        return [x if r == self.model_rank else self.others(axis, x)
                for r in range(self.shape[axis])]


def test_autograd_collectives_are_identities_without_a_mesh():
    """With no mesh, ``reduce_model``, ``copy_model`` and ``gather_model``
    return their input, with and without a gradient."""
    x = torch.randn(3, 4, requires_grad=True)
    for fn in (t_sh.reduce_model, t_sh.copy_model, lambda t: t_sh.gather_model(t, -1)):
        assert fn(x) is x
        with torch.no_grad():
            assert fn(x) is x


def test_autograd_collectives_transpose_as_megatrons_pair():
    """Under a two-rank stand-in whose other rank holds the same x: reduce
    sums in the forward and passes the gradient on; copy is the identity
    whose gradient is summed; the head's gather concatenates and hands
    each rank its block of the gradient back.  With no gradient each is
    the serving path's call."""
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    g = torch.tensor([[1.0, -2.0, 3.0], [0.5, 0.25, -1.0]])
    with t_sh.use_mesh(_Fake()):
        y = t_sh.reduce_model(x)
        assert torch.equal(y, 2 * x.detach())
        assert torch.equal(torch.autograd.grad(y, x, g)[0], g)
        y = t_sh.copy_model(x)
        assert torch.equal(y, x.detach())
        assert torch.equal(torch.autograd.grad(y, x, g)[0], 2 * g)
        with torch.no_grad():
            assert t_sh.copy_model(x) is x
            assert torch.equal(t_sh.reduce_model(x), 2 * x.detach())
    for rank in (0, 1):
        with t_sh.use_mesh(_Fake(model_rank=rank)):
            y = t_sh.gather_model(x, -1)
            assert torch.equal(y, torch.cat([x.detach(), x.detach()], dim=-1))
            gy = torch.arange(12.0).reshape(2, 6)
            assert torch.equal(torch.autograd.grad(y, x, gy)[0], gy[:, 3 * rank:3 * rank + 3])


def test_loss_normaliser_counts_the_global_batch():
    """Two data ranks' ``lm_loss_chunked`` on their halves of a batch with
    masked labels (unequal valid counts) add up to the whole batch's mean
    loss: each divides by the count summed over ``data``."""
    cfg = dataclasses.replace(t_get_config("yi-6b").reduced(), param_dtype="float32",
                              act_dtype="float32").with_numerics("default=f32")
    model = t_tf.lm_init(cfg, seed=1, device="cpu")
    g = torch.Generator().manual_seed(0)
    hidden = torch.randn(4, 24, cfg.d_model, generator=g)
    labels = torch.randint(0, cfg.vocab, (4, 24), generator=g)
    labels[:2, :17] = -1  # the first data rank's rows hold far fewer labels
    whole = t_tf.lm_loss_chunked(cfg, model, hidden, labels, chunk=8)
    counts = [(labels[:2] >= 0).sum().float(), (labels[2:] >= 0).sum().float()]
    parts = []
    for d in (0, 1):
        other = counts[1 - d]
        mesh = _Fake(model=1, data=2, others=lambda axis, x, o=other: o)
        with t_sh.use_mesh(mesh):
            parts.append(t_tf.lm_loss_chunked(cfg, model, hidden[2 * d:2 * d + 2],
                                              labels[2 * d:2 * d + 2], chunk=8))
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-6, atol=0)
    assert not torch.allclose((parts[0] + parts[1]) / 2, whole)  # a local mean would differ


@pytest.mark.parametrize("arch,tp", [("yi-6b", 2), ("yi-6b", 4), ("granite-moe-1b-a400m", 2)],
                         ids=["yi-tp2", "yi-tp4-replicated-kv", "granite-tp2"])
def test_gradient_norm_over_shards_is_the_whole_models(arch, tp):
    """``Zero1.global_norm`` on each rank's slices (a replicated kv leaf's
    whole gradient, as the step hands it over), with the model axis'
    sum of the other ranks' squares, equals ``global_norm`` of the whole
    gradients."""
    cfg = dataclasses.replace(t_get_config(arch).reduced(), param_dtype="float32")
    rng = np.random.default_rng(5)
    whole = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
             for n, p in t_tf.lm_init(cfg, device="meta").named_parameters()}
    want = global_norm(whole)
    layouts = t_sh.leaf_layouts(cfg, t_sh.Mesh(0, tp))

    def local(rank):
        return {n: g if layouts[n].partial else layouts[n].local(g, rank)
                for n, g in whole.items()}

    def cut_squares(rank):
        return sum(float(torch.sum(g * g)) for n, g in local(rank).items()
                   if layouts[n].dim is not None and not layouts[n].partial)

    assert any(lay.partial for lay in layouts.values()) == (cfg.n_kv < tp)
    for rank in range(tp):
        rest = sum(cut_squares(r) for r in range(tp) if r != rank)
        mesh = _Fake(model_rank=rank, model=tp,
                     others=lambda axis, x, rest=rest: torch.tensor(rest, dtype=x.dtype))
        zero = Zero1(layouts, mesh)
        torch.testing.assert_close(zero.global_norm(local(rank)), want, rtol=1e-6, atol=0)
