"""The port's serving CLI (``python -m repro_torch.launch.serve``) against
``repro.launch.serve``.

The parser keeps the reference's flags and defaults and adds
``--device``; ``options_from_args`` gives the reference's
``ServeOptions`` for the legacy and modern spellings of
tests/test_api.py, with one DeprecationWarning; ``main`` on the CPU
prints the reference's summary and request lines with the JAX CLI's
greedy tokens when both serve the same weights (the JAX init at the
run's seed, converted), and writes a trace and a Prometheus file that
both packages' checkers accept.  Tensor parallelism raises
``NotImplementedError`` naming its ``ROADMAP.md`` item, a run without
``--continuous`` serves on the static engine, and without a card and
without ``--device cpu`` the CLI raises.
"""
import dataclasses
import json
import re
import sys
import warnings

import pytest
import torch

jax = pytest.importorskip("jax")

from repro.launch import serve as j_serve  # noqa: E402
from repro.serving import observability as j_obs  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.serving import observability as t_obs  # noqa: E402

REDUCED = ["--arch", "yi-6b", "--reduced", "--continuous", "--batch", "3",
           "--prompt-len", "10", "--new-tokens", "5"]


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     type(a).__name__) for a in parser._actions}


def test_parser_has_the_reference_flags_and_defaults():
    want = _flags(j_serve.make_parser())
    got = _flags(t_serve.make_parser())
    assert got.pop("device") == (("--device",), None, None, None, "_StoreAction")
    assert got == want


@pytest.mark.parametrize("spelling", ["legacy", "modern"])
def test_options_match_reference(spelling):
    base = ["--arch", "yi-6b", "--continuous"]
    extra = (["--spec-k", "3", "--preemption", "recompute", "--priority", "2",
              "--deadline-s", "9.5"] if spelling == "legacy" else
             ["--opt", "spec_k=3", "--opt", "preemption=recompute", "--opt", "priority=2",
              "--opt", "deadline_s=9.5"])
    opts = {}
    for name, mod in (("port", t_serve), ("jax", j_serve)):
        args = mod.make_parser().parse_args(base + extra)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            opts[name] = mod.options_from_args(args)
        dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
        assert len(dep) == (1 if spelling == "legacy" else 0), name
        if dep:
            for flag in ("--spec-k", "--preemption", "--priority", "--deadline-s"):
                assert flag in str(dep[0].message)
    assert dataclasses.asdict(opts["port"]) == dataclasses.asdict(opts["jax"])
    assert opts["port"].spec_k == 3 and opts["port"].deadline_s == 9.5


def test_opt_flag_rejects_unknown_keys():
    args = t_serve.make_parser().parse_args(["--arch", "yi-6b", "--opt", "not_a_field=1"])
    with pytest.raises(SystemExit):
        t_serve.options_from_args(args)


def _jax_weights(seed):
    """The weights the JAX CLI serves at ``seed``, converted for the port."""
    from repro.configs import get_config as j_get_config
    from repro.models import build as j_build
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.convert import params_from_jax
    from test_torch_chunked import _numpy_tree

    jc = dataclasses.replace(j_get_config("yi-6b").reduced(), param_dtype="float32",
                             act_dtype="float32")
    tc = dataclasses.replace(t_get_config("yi-6b").reduced(), param_dtype="float32",
                             act_dtype="float32")
    jp = j_build(jc).init(jax.random.PRNGKey(seed))
    return params_from_jax(_numpy_tree(jp), tc, device="cpu")


def _summary(line):
    """The summary line without its two wall-time fields."""
    return re.sub(r" step_p(50|95)=[0-9.]+ms", "", line)


@pytest.mark.parametrize("extra", [
    ["--numerics-policy", "default=f32"],
    ["--numerics-policy", "default=f32", "--prefill-chunk", "8", "--opt", "spec_k=2",
     "--opt", "prefix_cache=true"],
], ids=["f32", "f32-chunk8-spec2-prefix"])
def test_main_prints_the_reference_tokens_and_writes_checked_files(
        extra, tmp_path, monkeypatch, capsys):
    import repro_torch.serving as t_serving

    seed = 3
    argv = REDUCED + extra + ["--seed", str(seed)]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve.main()
    want = capsys.readouterr().out.splitlines()

    model = _jax_weights(seed)
    build = t_serving.build_engine
    monkeypatch.setattr(t_serving, "build_engine",
                        lambda cfg, opts, init_seed, device: build(
                            cfg, opts, params=model, device=device))
    for name in ("t.json", "t.jsonl"):
        t_serve.main(argv + ["--device", "cpu", "--trace-out", str(tmp_path / name),
                             "--metrics-out", str(tmp_path / "m.prom")])
        got = capsys.readouterr().out.splitlines()
        assert _summary(got[0]) == _summary(want[0])
        assert [ln for ln in got if ln.startswith("req[")] == [
            ln for ln in want if ln.startswith("req[")]
        assert len([ln for ln in got if ln.startswith("  queue=")]) == 3
    trace = json.loads((tmp_path / "t.json").read_text())
    assert {e["ph"] for e in trace["traceEvents"]} >= {"X", "i", "M"}
    prom = (tmp_path / "m.prom").read_text()
    steps = int(re.search(r" steps=(\d+)", got[0]).group(1))
    assert f"serve_steps_total {float(steps)}" in prom
    assert 'serve_macs_total{mode="f32"}' in prom
    for mod in (t_obs, j_obs):
        counts = mod.check_trace_file(str(tmp_path / "t.jsonl"))
        assert counts["requests"] == counts["terminal"] == 3
        assert mod.check_prom_file(str(tmp_path / "m.prom")) > 0


def test_main_without_trace_skips_the_trace_file(tmp_path, capsys):
    t_serve.main(REDUCED + ["--numerics-policy", "default=f32", "--device", "cpu",
                            "--opt", "trace=false", "--trace-out", str(tmp_path / "t.jsonl")])
    out = capsys.readouterr().out
    assert "trace-out skipped" in out and "  queue=" not in out
    assert not (tmp_path / "t.jsonl").exists()


@pytest.mark.parametrize("argv,item", [
    (["--arch", "yi-6b", "--reduced"], None),
    (REDUCED + ["--tp", "2", "--device", "cpu"], "tp"),
    (REDUCED + ["--force-host-devices", "8"], "tp"),
], ids=["static", "tp2", "force-host-devices"])
def test_later_slices_raise(argv, item, capsys):
    """The options that once named a later slice serve.  The static engine
    (a run without --continuous): the reference's summary line and one
    batch row a prompt (its tokens against the JAX CLI's are held in
    tests/test_torch_static_engine.py).  Tensor parallelism: ``--tp 2 --device
    cpu`` serves from two CPU ranks and ``--force-host-devices 8`` on host
    devices (the reference's meaning), each printing the ``--tp 1`` run's
    requests and tokens (tp = 2 against the JAX engine:
    tests/test_torch_tp_serving.py)."""
    if item is None:
        t_serve.main(argv + ["--device", "cpu", "--numerics-policy", "default=f32",
                             "--batch", "2", "--prompt-len", "6", "--new-tokens", "3"])
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("arch=yi-6b numerics='default=f32' step_p50=")
        assert [ln.split(":")[0] for ln in out[1:]] == ["batch[0]", "batch[1]"]
        return
    policy = ["--numerics-policy", "default=f32"]
    t_serve.main(REDUCED + policy + ["--device", "cpu"])
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("req[")]
    t_serve.main(argv + policy)
    out = capsys.readouterr().out.splitlines()
    tp = 2 if "--tp" in argv else 1
    summary = next(ln for ln in out if ln.startswith("arch="))
    assert f" tp={tp} " in summary
    assert [ln for ln in out if ln.startswith("req[")] == want and len(want) == 3
    if tp > 1:
        assert "mesh: 2 ranks on cpu over gloo" in out


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.main(REDUCED)


def test_profile_flag_wraps_phases_in_spans():
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        t_serve.main(REDUCED + ["--numerics-policy", "default=f32", "--device", "cpu",
                                "--profile"])
    names = {e.name for e in prof.events()}
    assert {"serve.prefill", "serve.decode"} <= names
