"""The launch shape of the aligned engine's slot histogram (B4, and B2's
smaller children; ops/aligned.py::slot_hist_smem and
slot_hist_launch_shape) on the CPU, at the HIGGS (28 features, 63 and
255 bins, chunks of 1024) and MSLR (137 features, 255 bins, chunks of
512) shapes: shared memory within an H100's opt-in limit, feature tiles
that cover every feature, tiles within the rows that bound the
fixed-point rounding, and a grid of the given CTAs per SM. The CTAs per
SM themselves come from the CUDA occupancy calculator on the card
(tests/test_torch_cuda.py)."""
import pytest

from lightgbm_tpu_torch.ops import aligned as A

# cudaDevAttrMaxSharedMemoryPerBlockOptin and the SMs of an H100 80GB HBM3
H100_SMEM_OPTIN, H100_SMS = 232448, 132
# (features, bins, rows per chunk, chunks of the engine's records, feature
# tiles): 10.5M and 2.27M rows plus the speculative slots' chunks
SHAPES = {"higgs63": (28, 63, 1024, 10_510, 1),
          "higgs255": (28, 255, 1024, 10_510, 1),
          "mslr": (137, 255, 512, 4_690, 4)}


@pytest.mark.parametrize("shape", SHAPES)
def test_slot_hist_smem(shape):
    """20 B a cell (hi/lo int32 of g and h, a u32 count) for the tile's
    features and a tile's chunk metadata, within the opt-in limit; the
    features cut into the fewest tiles of equal size; a tile is 16,384
    rows of whole chunks. HIGGS at 255 bins fits one feature tile, MSLR
    takes four."""
    F, B, C, _, tiles = SHAPES[shape]
    tile, fpb, smem = A.slot_hist_smem(C, F, B, H100_SMEM_OPTIN)
    assert tile * C == A.SLOT_HIST_TILE_ROWS
    assert smem == 20 * fpb * B + 8 * tile + 8 <= H100_SMEM_OPTIN
    assert -(-F // fpb) == tiles
    assert (tiles - 1) * fpb < F <= tiles * fpb
    if tiles > 1:       # one tile fewer would not fit
        assert 20 * -(-F // (tiles - 1)) * B + 8 * tile + 8 \
            > H100_SMEM_OPTIN


@pytest.mark.parametrize("ctas", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_slot_hist_launch_shape(shape, ctas):
    """The grid: one column of CTAs per feature tile, and in each the
    given CTAs on every SM shared among the feature tiles."""
    F, B, C, nc, tiles = SHAPES[shape]
    tile, fpb, smem, grid_x, grid_y = A.slot_hist_launch_shape(
        nc, C, F, B, ctas, H100_SMS, H100_SMEM_OPTIN)
    assert (tile, fpb, smem) == A.slot_hist_smem(C, F, B, H100_SMEM_OPTIN)
    assert grid_y == tiles
    assert grid_x == min(-(-nc // tile), ctas * H100_SMS // tiles)
    assert grid_x * grid_y <= ctas * H100_SMS


def test_slot_hist_launch_shape_small_and_odd():
    """A few chunks make one tile for one CTA; a chunk of a whole tile is
    a tile; a longer chunk, bins that leave no room for one feature, or
    no CTA fitting an SM, raise."""
    assert A.slot_hist_launch_shape(3, 256, 28, 63, 1, H100_SMS,
                                    H100_SMEM_OPTIN)[3:] == (1, 1)
    tile, _, _, grid_x, _ = A.slot_hist_launch_shape(
        10, A.SLOT_HIST_TILE_ROWS, 28, 63, 1, H100_SMS, H100_SMEM_OPTIN)
    assert (tile, grid_x) == (1, 10)
    with pytest.raises(ValueError, match="at most"):
        A.slot_hist_smem(A.SLOT_HIST_TILE_ROWS + 2, 28, 63, H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match="shared memory"):
        A.slot_hist_smem(1024, 28, 255, 4096)
    with pytest.raises(ValueError, match="no CTA"):
        A.slot_hist_launch_shape(100, 1024, 28, 255, 0, H100_SMS,
                                 H100_SMEM_OPTIN)
