"""The work list of the lambdarank kernel B6 (ops/rank.py::rank_work) on
the CPU: every document of every query is covered by exactly one item,
queries of at most 512 documents with labels below 32 are held whole
(packed up to 256 documents an item, never across a long query), every
other query is walked by at most 128 CTAs of row blocks, consecutive in
the list, each with its own counters, and empty queries take nothing.
The kernel itself runs on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest

from lightgbm_tpu_torch.ops import rank as R


def _covered(work, qb):
    """How many times each document is covered, and the query of each
    item's documents: short items own their queries' documents, CTA k of
    the m of a long query owns the row blocks k, k + m, ..."""
    n = int(qb[-1])
    times = np.zeros(n, np.int64)
    for kind, a, b, m in work.items.tolist():
        if kind & 1 == R.KIND_SHORT:
            times[qb[a]:qb[b]] += 1
            continue
        lo, hi = qb[a], qb[a + 1]
        for i0 in range(b * R.BLOCK_DOCS, hi - lo, m * R.BLOCK_DOCS):
            times[lo + i0:min(hi, lo + i0 + R.BLOCK_DOCS)] += 1
    return times


def _case(counts, seed=0, top=5):
    qb = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    lab = np.random.default_rng(seed).integers(0, top, int(qb[-1]))
    return qb, lab


@pytest.mark.parametrize("counts", [
    [5, 70, 200, 600, 3, 300, 9000, 40, 50, 60, 100, 2],
    [512, 513, 1, 256, 257, 0, 0, 64, 8193],
    list(np.random.default_rng(3).integers(80, 160, 400)),
], ids=["mixed", "edges", "mslr"])
def test_rank_work_covers_each_document_once(counts):
    qb, lab = _case(counts)
    work = R.rank_work(qb, lab)
    assert work.items.dtype == np.int32 and work.items.shape[1] == 4
    assert (_covered(work, qb) == 1).all()
    assert work.covers


def test_rank_work_short_long_split_at_512():
    """A query of 512 documents is held whole, one of 513 is long: 9 CTAs
    of 64-document row blocks; one of 8,193 takes the 128 CTAs' cap."""
    qb, lab = _case([512, 513, 8193])
    items = R.rank_work(qb, lab).items
    short = items[items[:, 0] & 1 == R.KIND_SHORT]
    assert short.tolist() == [[R.KIND_SHORT, 0, 1, 0]]
    long_ = items[items[:, 0] & 1 == R.KIND_LONG]
    assert (long_[:, 1] == 1).sum() == 9 and (long_[:, 1] == 2).sum() == 128
    assert set(long_[long_[:, 1] == 2, 3].tolist()) == {R.LONG_CTAS}


def test_rank_work_long_items_first_consecutive_with_own_slots():
    """The long items come first, each query's CTAs consecutive, k = 0 ..
    m - 1, one counter slot a long query; sync holds the ticket and two
    counters a long query, all zero."""
    qb, lab = _case([600, 40, 700, 30, 2000])
    work = R.rank_work(qb, lab)
    items = work.items
    kinds = items[:, 0] & 1
    assert (np.diff(kinds) <= 0).all()          # long, then short
    long_ = items[kinds == R.KIND_LONG]
    for slot, q in enumerate((0, 2, 4)):
        mine = long_[long_[:, 1] == q]
        assert (mine[:, 0] >> 1 == slot).all()
        assert mine[:, 2].tolist() == list(range(len(mine)))
        assert (mine[:, 3] == len(mine)).all()
        rows = np.nonzero(long_[:, 1] == q)[0]
        assert (np.diff(rows) == 1).all()
    assert work.sync.tolist() == [0] * 7


def test_rank_work_packing_and_empty_queries():
    """Short queries pack in order up to 256 documents, never across a
    long query; an empty query takes no item (it may lie inside a packed
    run, where it adds nothing); queries of all-empty input take none."""
    qb, lab = _case([100, 0, 100, 56, 1, 600, 10, 0, 0])
    items = R.rank_work(qb, lab).items
    short = items[items[:, 0] & 1 == R.KIND_SHORT]
    assert short.tolist() == [[0, 0, 4, 0], [0, 4, 5, 0], [0, 6, 7, 0]]
    empty = R.rank_work(np.zeros(4, np.int64), np.zeros(0, np.int64))
    assert empty.items.shape == (0, 4) and empty.sync.tolist() == [0]


def test_rank_work_large_labels_go_long():
    """A short query with a label of 32 or more cannot be held by label
    groups in shared memory: it takes the long walk."""
    qb, lab = _case([50, 50, 50])
    lab[60] = R.MAX_LABELS
    items = R.rank_work(qb, lab).items
    assert items[items[:, 0] & 1 == R.KIND_LONG][:, 1].tolist() == [1]
    assert (_covered(R.RankWork(items, None, True), qb) == 1).all()


def test_rank_work_partial_cover_and_negative_labels():
    """Offsets that leave documents out say so (the wrapper then zeroes g
    and h first); negative labels are refused."""
    lab = np.zeros(30, np.int64)
    assert not R.rank_work(np.asarray([5, 15, 30]), lab).covers
    assert not R.rank_work(np.asarray([0, 10, 20]), lab).covers
    lab[3] = -1
    with pytest.raises(ValueError, match="non-negative"):
        R.rank_work(np.asarray([0, 10, 30]), lab)
