"""The paged decode step's K/V write where rows share a destination.

Idle slots (length 0, table row at scratch block 0) all write the scratch
block's first key and read it back.  Under MoE their inputs differ (the
capacity drops differ by rank), so the write must give the reference's
last-wins result on every device, where ``index_put_`` on the card leaves
the winner of a duplicate index unspecified.  Port only: no JAX needed,
so the ``cuda`` case runs on the card.
"""
import pytest
import torch

from repro_torch.core.modes import NumericsConfig
from repro_torch.models.attention import Attention, attn_apply_paged, paged_write
from repro_torch.models.common import iter_layers

TOL = 1e-5  # f32, the same rows in a batch of another size


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_decode_duplicate_writes_take_the_last_row(device):
    """Idle slots (length 0, table row at scratch block 0) all write the
    scratch block's first key and read it back.  Under MoE their inputs
    differ, so the write gives the reference's last-wins result (that of
    ``.at[].set`` on the CPU) on every device: the key holds the last idle
    row's K/V, each idle row attends to it alone, and a live row's write
    lands in its own block."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; skips without one")
    d, heads, hd, bs, nb = 64, 2, 64, 4, 6
    g = torch.Generator(device=device).manual_seed(0)
    p = Attention(d, heads, heads, hd, generator=g, device=device)
    _, nsite = next(iter_layers(NumericsConfig(mode="f32"), 1))
    x = torch.randn((5, 1, d), generator=g, device=device)
    tables = torch.zeros((5, 2), dtype=torch.int32, device=device)
    tables[2] = torch.tensor([3, 4])  # row 2 is live at length 5: block 4, key 1
    lengths = torch.tensor([0, 0, 5, 0, 0], dtype=torch.int32, device=device)

    def step(rows):
        pools = [torch.zeros((nb, bs, heads, hd), device=device) for _ in range(2)]
        out, _ = attn_apply_paged(p, x[rows], nsite, n_heads=heads, n_kv=heads, head_dim=hd,
                                  lengths=lengths[rows], k_pages=pools[0], v_pages=pools[1],
                                  block_tables=tables[rows],
                                  write=paged_write(lengths[rows], tables[rows], bs))
        return out, pools

    out, pools = step([0, 1, 2, 3, 4])
    # each idle row's K/V and output when it is the only idle row (another
    # batch size: equal up to f32 rounding on the card)
    alone = {r: step([2, r]) for r in (0, 1, 3, 4)}
    for r in (0, 1, 3):
        assert (pools[0][0, 0] - alone[r][1][0][0, 0]).abs().max() > 0.1  # rows differ
    for got, want in zip(pools, alone[4][1]):
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)  # the last idle row's
    torch.testing.assert_close(out[2], alone[4][0][0], rtol=TOL, atol=TOL)
    for r in (0, 1, 3, 4):
        torch.testing.assert_close(out[r], alone[4][0][1], rtol=TOL, atol=TOL)
