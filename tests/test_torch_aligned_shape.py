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


# (rows per chunk, used lanes, the engine's lanes W) of the partition at
# HIGGS 63 (COMPACT: 6 bin words + score + meta), HIGGS 255 (7 + 2) and
# MSLR EXT (35 bin words + score, grad, hess, rid)
MOVE_SHAPES = {"higgs63": (1024, 8, 8), "higgs255": (1024, 9, 16),
               "mslr_ext": (512, 39, 40)}


@pytest.mark.parametrize("shape", MOVE_SHAPES)
def test_move_smem(shape):
    """The partition stages every used lane of a chunk at once within an
    H100's opt-in (32, 36 and 78 KB of lanes), beside a 16-byte mbarrier,
    a u16 row permutation, two words a 32-row ballot and a categorical
    split's 8 bitset words."""
    C, w_used, _ = MOVE_SHAPES[shape]
    lanes, smem = A.move_smem(C, w_used, H100_SMEM_OPTIN)
    assert lanes == w_used
    assert smem == 16 + 4 * w_used * C + 2 * C + 8 * (C // 32) + 32
    assert smem <= H100_SMEM_OPTIN - 256
    # two CTAs an SM at the widest (four of 256 threads at HIGGS)
    assert 2 * smem <= 228 * 1024 - 2 * 1024


def test_move_smem_small_optin_and_odd_chunks():
    """Shared memory for fewer lanes stages them in turn; a chunk that does
    not fit one lane, more than 65,535 rows (u16 permutation) or rows not
    a multiple of 4 (16-byte bulk copies) raise."""
    lanes, smem = A.move_smem(512, 39, 40 * 1024)
    assert lanes == (40 * 1024 - 256 - 16 - 1024 - 128 - 32) // 2048 == 19
    assert smem <= 40 * 1024 - 256
    with pytest.raises(ValueError, match="does not fit"):
        A.move_smem(1024, 8, 4096)
    with pytest.raises(ValueError, match="multiple of 4"):
        A.move_smem(1022, 8, H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match="65,535"):
        A.move_smem(65536, 8, H100_SMEM_OPTIN)


@pytest.mark.parametrize("ctas", [4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_count_launch_shape(shape, ctas):
    """B3's persistent grid: the given CTAs on every SM when the chunks
    give every warp one, a u32 counter a slot (the engine's 256 at most)
    in shared memory."""
    _, _, _, nc, _ = SHAPES[shape]
    smem, grid = A.count_launch_shape(nc, 256, ctas, H100_SMS,
                                      H100_SMEM_OPTIN)
    assert smem == 4 * 256
    assert grid == min(ctas * H100_SMS, -(-nc // (A.COUNT_THREADS // 32)))


def test_count_launch_shape_small_and_odd():
    """Few chunks take one CTA for every 8 (a chunk a warp), no chunk one
    CTA (it writes the zero counts); counters beyond the opt-in, or no
    CTA fitting an SM, raise."""
    assert A.count_launch_shape(17, 1, 8, H100_SMS, H100_SMEM_OPTIN) \
        == (4, 3)
    assert A.count_launch_shape(0, 200, 8, H100_SMS, H100_SMEM_OPTIN) \
        == (800, 1)
    with pytest.raises(ValueError, match="exceed"):
        A.count_launch_shape(100, H100_SMEM_OPTIN // 4, 8, H100_SMS,
                             H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match="no CTA"):
        A.count_launch_shape(100, 256, 0, H100_SMS, H100_SMEM_OPTIN)
