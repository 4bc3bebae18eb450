"""posit_quant's straight-through quantize (``core/modes.py``): K3's
``posit_quantize`` on a CUDA tensor, its plain version on the CPU, the
same values and the reference's STE gradient either way.  Port only (no
JAX), so the ``cuda`` cases run on the card."""
import numpy as np
import pytest
import torch

from repro_torch.core.modes import NumericsConfig, nmatmul, nquant_weight, posit_quantize_ste
from repro_torch.kernels import _lib, posit_codec
from repro_torch.numerics import P16, quantize

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; skips without one")
    return torch.device(name)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("carrier", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_quantize_ste_value_gradient_and_route(device, carrier, x_dtype, monkeypatch):
    """The value of the plain quantize in the carrier dtype; the cotangent
    cast through the carrier to the input's dtype; one K3 launch and no
    plain codec call on the card, the plain version on the CPU."""
    dev = _device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn((64, 256), generator=g, device=dev) * 3).to(x_dtype)
    x.requires_grad_(True)
    ct = torch.randn((64, 256), generator=g, device=dev)
    plain_calls = []
    real = posit_codec.quantize_plain
    monkeypatch.setattr(posit_codec, "quantize_plain",
                        lambda *a: plain_calls.append(1) or real(*a))
    _lib.reset_launches()
    q = posit_quantize_ste(x, P16, carrier)
    launches = _lib.launches["posit_codec"]
    monkeypatch.undo()
    assert (launches, len(plain_calls)) == ((1, 0) if device == "cuda" else (0, 1))
    want = quantize(x.detach().to(torch.float32), P16).to(carrier)
    assert q.dtype == carrier and torch.equal(q, want)
    (dx,) = torch.autograd.grad(q, x, ct.to(carrier))
    assert dx.dtype == x_dtype
    assert torch.equal(dx, ct.to(carrier).to(x_dtype))


@pytest.mark.parametrize("device", DEVICES)
def test_projection_gradient_is_straight_through(device):
    """The gradient of sum(nmatmul(x, w)**2) under posit_quant is that of the
    exact matmul of the quantized operands (the reference's STE)."""
    dev = _device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32)).to(dev)
    x.requires_grad_(True)
    w.requires_grad_(True)
    torch.sum(nmatmul(x, w, NumericsConfig(mode="posit_quant")) ** 2).backward()
    xq, wq = quantize(x.detach(), P16), quantize(w.detach(), P16)
    y = xq @ wq
    torch.testing.assert_close(x.grad, 2 * y @ wq.T)
    torch.testing.assert_close(w.grad, xq.T @ (2 * y))


@pytest.mark.parametrize("device", DEVICES)
def test_nquant_weight_projects_in_the_weight_dtype(device):
    dev = _device(device)
    w = torch.randn((64, 32), device=dev).to(torch.bfloat16)
    got = nquant_weight(w, NumericsConfig(mode="posit_quant"))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, quantize(w.to(torch.float32), P16).to(torch.bfloat16))
    assert nquant_weight(w, NumericsConfig(mode="f32")) is w
