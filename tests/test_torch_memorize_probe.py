"""``launch/memorize_probe.py`` on the CPU at reduced size: its reading of
the batch before and after each step is the loss that the training cell's
own step reports, and it refuses a family without a dense LM head."""
import dataclasses

import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun, memorize_probe
from repro_torch.models.registry import vlm_patches


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "yi-6b"])
def test_reads_are_the_steps_losses(arch):
    """Step i reports the loss of the batch before its update: the probe's
    read after i steps."""
    got = memorize_probe.probe(arch, 2, 2, 16, 2, "cpu", reduced=True)
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    seq = 16 + (vlm_patches(cfg) if cfg.family == "vlm" else 0)
    step, (model, opt, batch) = dryrun.build_cell(cfg, ShapeSpec("probe", seq, 2, "train"),
                                                  device=torch.device("cpu"))
    losses = [float(step(model, opt, batch)[2]["loss"]) for _ in range(2)]
    assert [r["loss"] for r in got[:2]] == pytest.approx(losses, rel=1e-6)
    for r in got:
        assert 0.0 <= r["gold_is_argmax"] <= 1.0
        assert r["lse_minus_gold_max"] >= r["loss"] >= 0.0


def test_refuses_a_family_without_a_dense_head():
    with pytest.raises(ValueError, match="dense or vlm"):
        memorize_probe.probe("mamba2-780m", 2, 1, 16, 2, "cpu", reduced=True)
