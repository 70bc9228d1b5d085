"""P1 `slot_hist`'s launch shape (ops/proto.py::slot_hist_smem and
slot_hist_launch_shape) on the CPU: shared memory within an H100's
opt-in limit, tiles within the rows that bound the fixed-point rounding,
and a grid of the given CTAs per SM. The CTAs per SM themselves come
from the CUDA occupancy calculator on the card (tests/test_torch_cuda.py)."""
import pytest

from lightgbm_tpu_torch.ops import proto as P
from lightgbm_tpu_torch.tools import proto_aligned as HA

# cudaDevAttrMaxSharedMemoryPerBlockOptin and the SMs of an H100 80GB HBM3
H100_SMEM_OPTIN, H100_SMS = 232448, 132
B_PADS = (256, 64, 16)


@pytest.mark.parametrize("b_pad", B_PADS)
@pytest.mark.parametrize("chunk", [256, 512])
def test_slot_hist_smem(chunk, b_pad):
    """A CTA's shared memory holds 20 B a cell (hi/lo int32 of g and h, a
    u32 count) and a tile's chunk metadata, within the opt-in limit; a
    tile is 16,384 rows of whole chunks."""
    tile, smem = P.slot_hist_smem(chunk, HA.NUM_FEATURES, b_pad)
    assert 20 * HA.NUM_FEATURES * b_pad < smem <= H100_SMEM_OPTIN
    assert smem - 20 * HA.NUM_FEATURES * b_pad == 8 * tile + 8
    assert tile * chunk == P.SLOT_HIST_TILE_ROWS


@pytest.mark.parametrize("ctas", [1, 2, 4])
@pytest.mark.parametrize("chunk", [256, 512])
def test_slot_hist_launch_shape(chunk, ctas):
    """At the harness's size the grid is the given CTAs on every SM, the
    tile and shared memory those of `slot_hist_smem`."""
    nc = HA.N_ROWS // chunk
    for b_pad in B_PADS:
        tile, smem, grid = P.slot_hist_launch_shape(
            nc, chunk, HA.NUM_FEATURES, b_pad, ctas, H100_SMS)
        assert (tile, smem) == P.slot_hist_smem(chunk, HA.NUM_FEATURES,
                                                b_pad)
        assert grid == min(-(-nc // tile), ctas * H100_SMS) \
            == ctas * H100_SMS


def test_slot_hist_launch_shape_small_and_odd():
    """A few chunks make one tile for one CTA; a chunk of a whole tile
    is a tile; a longer chunk, or no CTA fitting an SM, raise."""
    assert P.slot_hist_launch_shape(3, 256, 28, 16, 1, H100_SMS)[::2] \
        == (64, 1)
    tile, _, grid = P.slot_hist_launch_shape(
        10, P.SLOT_HIST_TILE_ROWS, 28, 16, 1, H100_SMS)
    assert (tile, grid) == (1, 10)
    with pytest.raises(ValueError, match="at most"):
        P.slot_hist_launch_shape(10, P.SLOT_HIST_TILE_ROWS + 2, 28, 16, 1,
                                 H100_SMS)
    with pytest.raises(ValueError, match="shared memory"):
        P.slot_hist_launch_shape(100, 256, 28, 256, 0, H100_SMS)
