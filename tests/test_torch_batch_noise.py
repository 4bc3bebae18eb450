"""The batch-noise probe (``repro_torch/launch/batch_noise.py``) on the CPU:
its reading of a batch folded between other dimensions, its op-by-op
comparison of a batch-2 and a batch-4 run (an op whose inputs' rows agree
and whose output's do not is named), and where greedy tokens part.  The
tool itself runs on a card; here its parts run on small tensors and a
reduced mamba2-780m."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import batch_noise as bn

from test_torch_ssm import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("fold", ["outer", "middle", "inner"])
def test_rows_of_reads_a_folded_batch(fold):
    """A [4, 3, 5] batch-4 tensor and its batch-2 rows, folded with another
    dimension before, around or after the batch: one of ``rows_of``'s
    readings is the batch-2 tensor."""
    g = torch.Generator().manual_seed(0)
    x4 = torch.randn(4, 3, 5, generator=g)
    x2 = x4[:2]
    if fold == "outer":
        big, small = x4.reshape(12, 5), x2.reshape(6, 5)
    elif fold == "middle":
        big, small = x4.permute(1, 0, 2).reshape(12, 5), x2.permute(1, 0, 2).reshape(6, 5)
    else:
        big, small = x4.permute(1, 2, 0).reshape(15, 4), x2.permute(1, 2, 0).reshape(15, 2)
    assert bn._agree(big, small)
    assert not bn._agree(big + 1, small)
    assert bn._diff(big + 1, small) == pytest.approx(1.0)


def test_probe_names_the_op_whose_result_depends_on_the_batch():
    """Row-wise ops agree between the runs; a sum over the whole batch
    parts with agreeing inputs and is the one origin named."""
    g = torch.Generator().manual_seed(1)
    x4 = torch.randn(4, 8, generator=g)
    x2 = x4[:2].clone()

    def f(x):
        y = torch.tanh(x) * 2.0
        return y + y.sum()

    _, store = bn.probed(lambda: f(x2))
    _, run = bn.probed(lambda: f(x4), store.ops)
    assert [r["what"].split("(")[0] for r in run.origins] == ["aten.sum.default"]
    assert all(not r["inputs_agree"] for r in run.differ if r not in run.origins)
    with pytest.raises(RuntimeError, match="where the stored run had"):
        bn.probed(lambda: torch.cos(x4), store.ops)


def test_probe_over_a_reduced_mamba2():
    """The prefill and a decode step of a reduced mamba2-780m under
    ``plam_sim:16:1`` (K1's plain version here) go through the probe at
    batch 2 and 4 with the same op sequence; every K1 call is one op."""
    cfg = get_config("mamba2-780m").reduced().with_numerics("default=plam_sim:16:1")
    model = bn.model_for(cfg, "cpu")
    prompt = bn.prompts(cfg, [3], "cpu")[3][:, :16].contiguous()
    res = bn.probe_ops(cfg, model, prompt)
    for form in ("prefill", "decode"):
        assert res[form]["ops"] > 0
        assert res[form]["differ"] >= len(res[form]["origins"])
    assert all("K1" not in k for k in res["origin_ops"])


def test_departures_report_where_tokens_part():
    want = {"tokens": torch.tensor([[1, 2, 3], [4, 5, 6]]),
            "top": torch.tensor([[1.0, 2.0, 3.0], [1.0, 1.0, 1.0]]),
            "margins": torch.tensor([[0.5, 0.25, 0.125], [0.1, 0.2, 0.3]])}
    got = {"tokens": torch.tensor([[1, 2, 9], [4, 5, 6]]),
           "top": torch.tensor([[1.0, 2.5, 0.0], [1.0, 1.0, 1.25]]),
           "margins": want["margins"]}
    res = bn.departures(got, want)
    assert res["parts"] == [(0, 2, 0.125)]
    assert res["top_logit_gap"] == pytest.approx(0.5)
