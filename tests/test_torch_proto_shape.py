"""The prototype kernels' launch shapes (ops/proto.py) on the CPU: P1
`slot_hist`'s (slot_hist_smem and slot_hist_launch_shape: shared memory
within an H100's opt-in limit, tiles within the rows that bound the
fixed-point rounding, a grid of the given CTAs per SM), P2 `move`'s
(move_smem) and P3 `ring_stage`'s (ring_launch_shape and its scratch).
The CTAs per SM themselves come from the CUDA occupancy calculator on
the card (tests/test_torch_cuda.py)."""
import pytest

from lightgbm_tpu_torch.ops import proto as P
from lightgbm_tpu_torch.tools import proto_aligned as HA
from lightgbm_tpu_torch.tools import proto_roll as HR

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


@pytest.mark.parametrize("chunk", HA.CHUNKS)
def test_move_smem(chunk):
    """P2's CTA takes a tile of 2,048 rows (8 chunks of 256, 4 of 512)
    and stages two whole chunks (16 and 32 KB each) beside two mbarriers,
    the tile's u16 row permutations padded to 16 bytes and two words a
    32-row ballot, within an H100's opt-in; at least three CTAs fit an SM
    (228 KB less 1 KB reserved a CTA and the static fields), four at 256
    rows."""
    tile, stages, smem = P.move_smem(chunk, H100_SMEM_OPTIN)
    assert tile * chunk == P.MOVE_TILE_ROWS and stages == 2
    assert smem == 16 + 2 * 4 * P.W * chunk + 2 * tile * chunk \
        + 8 * tile * (chunk // 32)
    assert smem <= H100_SMEM_OPTIN - 1024
    fit = 228 * 1024 // (smem + 1024 + 1024)
    assert fit >= (4 if chunk == 256 else 3)


def test_move_smem_tiles_stages_and_odd_chunks():
    """Tiles of at most 32 chunks and at least one; room for one chunk
    but not two stages one (any row count: a whole chunk is 64 C bytes);
    two stages up to 1,776 rows at the H100's opt-in; a chunk that does
    not fit one stage, or more than 65,535 rows, raise."""
    assert P.move_smem(16, H100_SMEM_OPTIN)[0] == P.MOVE_MAX_TILE
    assert P.move_smem(4096, 2 * H100_SMEM_OPTIN)[:2] == (1, 1)
    assert P.move_smem(512, 60 * 1024) == (
        4, 1, 16 + 4 * P.W * 512 + 4096 + 8 * 4 * 16)
    assert P.move_smem(250, H100_SMEM_OPTIN) == (
        8, 2, 16 + 2 * 4 * P.W * 250 + 4000 + 8 * 8 * 8)
    assert P.move_smem(1776, H100_SMEM_OPTIN)[1] == 2
    assert P.move_smem(1777, H100_SMEM_OPTIN)[1] == 1
    with pytest.raises(ValueError, match="does not fit"):
        P.move_smem(4096, H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match="65,535"):
        P.move_smem(65536, H100_SMEM_OPTIN)


@pytest.mark.parametrize("ctas", [1, 4, 8])
def test_ring_launch_shape_at_the_harness_size(ctas):
    """P3 at the harness's 20,000 chunks on an H100's 132 SMs: as many
    CTAs of 256 threads as the SMs hold (a warp counts a chunk at a
    time, so 2,500 CTAs would give every warp one), and a scratch of a
    total a CTA and a count a chunk, under 90 KB; one CTA an SM
    finishes."""
    grid, fin, most = P.ring_launch_shape(HR.N_CHUNKS, ctas, H100_SMS)
    assert most == ctas * H100_SMS
    assert grid == min(most, HR.N_CHUNKS // (P.RING_THREADS // 32))
    assert fin == H100_SMS                   # one finishing CTA an SM
    words = P.ring_scratch_words(HR.N_CHUNKS, most)
    assert words == most + HR.N_CHUNKS
    assert 4 * words < 90 * 1024


def test_ring_launch_shape_small_and_refused():
    """Fewer CTAs when the chunks give fewer than one a warp, one with no
    chunk at all (it still zeroes the staging), and as many finishing;
    no CTA on an SM raises."""
    assert P.ring_launch_shape(0, 8, H100_SMS) == (1, 1, 8 * H100_SMS)
    assert P.ring_launch_shape(1, 8, H100_SMS)[:2] == (1, 1)
    assert P.ring_launch_shape(17, 8, H100_SMS)[:2] == (3, 3)
    assert P.ring_launch_shape(10 ** 6, 2, H100_SMS)[0] == 2 * H100_SMS
    with pytest.raises(ValueError, match="no CTA"):
        P.ring_launch_shape(100, 0, H100_SMS)
