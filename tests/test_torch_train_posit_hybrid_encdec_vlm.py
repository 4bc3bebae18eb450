"""Training of the hybrid, encdec and vlm families under ``posit_quant`` (K3's quantize
on both operands of every projection, its plain version on the CPU,
with a straight-through gradient): the port's loss and every leaf of its
gradient against ``jax.value_and_grad`` of the reference's, within loss
rtol 1e-4 and a per-leaf relative L2 of 1e-3.  The helpers, and the f32
cases, are in ``test_torch_train_families.py``.
"""
import pytest

pytest.importorskip("jax")
from test_torch_train_families import check_against_reference, one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "seamless-m4t-medium", "qwen2-vl-72b"])
def test_posit_quant_loss_and_every_gradient_leaf_match_reference(arch):
    check_against_reference(arch, "posit_quant")
