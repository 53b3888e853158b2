"""The port's doc-range sharding (fugu_tpu_torch/parallel) against the
reference's sharded functions and the NumPy oracle.

Every case builds its segment with each package's SegmentBuilder from
the same seeded texts and puts the same plans through the reference's
sharded function (a JAX CPU mesh of tests/conftest.py's 8 virtual
devices, its Pallas kernels in interpret mode, as the reference's own
tests run them), through the port's counterpart on a CPU mesh
(``make_mesh(n, device="cpu")``: every kernel wrapper runs its plain
PyTorch version) and through the oracle.  Tolerance 0: equal float32
scores and equal doc ids, in the same order.  The cases are those of
tests/test_sharded.py, tests/test_pallas_sharded.py,
tests/test_batch_sharded.py and tests/test_phrase_sharded.py, then the
port's own: ties across shard bounds, a 2-D merge against a flat one,
more shards than docs, residency of a mesh on one device, the dry run,
and the imports of the package."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fugu_tpu.index.schema
import fugu_tpu.index.segment
import fugu_tpu.ops.oracle
import fugu_tpu_torch.index.schema
import fugu_tpu_torch.index.segment
import fugu_tpu_torch.ops.oracle
from fugu_tpu.ops import phrase_stream as ref_phrase_stream
from fugu_tpu.parallel import batch_sharded as ref_bsh
from fugu_tpu.parallel import pallas_sharded as ref_psh
from fugu_tpu.parallel import phrase_sharded as ref_phsh
from fugu_tpu.parallel import sharded as ref_sharded
from fugu_tpu_torch.ops import batch_scorer, block_scorer, residency
from fugu_tpu_torch.ops import oracle
from fugu_tpu_torch.ops import phrase_stream
from fugu_tpu_torch.ops.staging import has_nonpositive_weight
from fugu_tpu_torch.parallel import batch_sharded as bsh
from fugu_tpu_torch.parallel import block_sharded as bksh
from fugu_tpu_torch.parallel import phrase_sharded as phsh
from fugu_tpu_torch.parallel import sharded
from fugu_tpu_torch.query import (
    Occur,
    PhraseClause,
    QueryGroup,
    QueryPlan,
    TermClause,
)
from test_torch_phrase_stream import _pack_index
from test_torch_slice import to_ref_plan

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def build(root, docs, tomb=None):
    """A segment of ``docs`` ((fields, facets) pairs) built with
    ``root``'s SegmentBuilder; ``tomb`` slices the tombstones to set."""
    b = root.index.segment.SegmentBuilder(root.index.schema.DOCS_SCHEMA)
    for i, (fields, facets) in enumerate(docs):
        b.add_document(fields, facets=facets, stored={"id": f"d{i}"})
    seg = b.build()
    if tomb is not None:
        seg.tombstones[tomb] = True
    return seg


def pair(docs, tomb=None):
    """(port segment, reference segment) of the same docs."""
    return build(fugu_tpu_torch, docs, tomb), build(fugu_tpu, docs, tomb)


def key(hits):
    """The bit-level identity of a result: [(f32 score, doc)]."""
    return None if hits is None else [(np.float32(s), int(d)) for s, d in hits]


def expect(seg, plan, limit):
    stats = oracle.IndexStats([seg])
    return key((h.score, h.doc) for h in oracle.search([seg], plan, limit, stats))


def cpu_mesh(n, n_slices=1):
    return sharded.make_mesh(n, n_slices=n_slices, device="cpu")


def should(*words):
    return QueryPlan(groups=tuple(
        QueryGroup(Occur.SHOULD, (TermClause("text", w),)) for w in words))


def must(*words):
    return QueryPlan(groups=tuple(
        QueryGroup(Occur.MUST, (TermClause("text", w),)) for w in words))


def facet(path):
    return TermClause("", path, is_facet=True)


def phrase(words, occur=Occur.SHOULD, slop=0, boost=1.0):
    return QueryPlan(groups=(QueryGroup(occur, phrases=(
        PhraseClause("text", tuple(words), boost=boost, slop=slop),)),))


# -- tests/test_sharded.py: the small-segment engine per shard -----------------


def sharded_docs():
    rng = np.random.default_rng(11)
    vocab = [f"w{i}" for i in range(40)]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    return [({"text": [" ".join(rng.choice(vocab, size=int(rng.integers(2, 40)),
                                            p=p))]},
             [f"/cat/{int(rng.integers(0, 4))}"]) for _ in range(500)]


@pytest.fixture(scope="module")
def small_pair():
    return pair(sharded_docs())


SHARDED_CASES = {
    "single_term": (should("w0"), 10, None),
    "multi_term": (should("w1", "w3", "w8"), 25, None),
    "boolean": (QueryPlan(groups=(
        QueryGroup(Occur.MUST, (TermClause("text", "w0"),)),
        QueryGroup(Occur.MUST, (TermClause("text", "w2"),)),
        QueryGroup(Occur.MUST_NOT, (TermClause("text", "w5"),)),
    )), 50, None),
    "facet_filter": (QueryPlan(groups=(
        QueryGroup(Occur.MUST, (TermClause("text", "w1"),)),
        QueryGroup(Occur.MUST, (facet("/cat/1"),)),
    )), 30, None),
    # 60 of 500 docs dead: w0's df passes the live doc count, so its
    # idf is negative
    "tombstones": (should("w0"), 20, slice(0, 60)),
}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_search_matches_reference(small_pair, case, n):
    pseg, rseg = small_pair
    plan, limit, tomb = SHARDED_CASES[case]
    try:
        if tomb is not None:
            pseg.tombstones[tomb] = True
            rseg.tombstones[tomb] = True
        stats = oracle.IndexStats([pseg])
        if case == "tombstones":
            assert float(fugu_tpu_torch.query.idf(
                stats.doc_freq("text", "w0"), stats.doc_count)) < 0
        got = sharded.sharded_search(
            sharded.ShardedPack(pseg, cpu_mesh(n)), plan, stats, limit)
        want = ref_sharded.sharded_search(
            ref_sharded.ShardedPack(rseg, ref_sharded.make_mesh(n)),
            to_ref_plan(plan), fugu_tpu.ops.oracle.IndexStats([rseg]), limit)
        assert key(got) == key(want) == expect(pseg, plan, limit)
        assert got
    finally:
        pseg.tombstones[:] = False
        rseg.tombstones[:] = False


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_tables_match_reference(small_pair, n):
    """Bounds, per-shard term tables and host packs equal the
    reference's ShardedPack on the same segment."""
    pseg, rseg = small_pair
    port = sharded.ShardedPack(pseg, cpu_mesh(n))
    ref = ref_sharded.ShardedPack(rseg, ref_sharded.make_mesh(n))
    assert port.bounds == ref.bounds
    assert port._term_tables == ref._term_tables
    for (pd, pk), (rd, rk), pack in zip(port.host_packs, ref.host_packs,
                                        port.packs):
        assert np.array_equal(pd, rd) and np.array_equal(pk, rk)
        assert torch.equal(pack.e_doc, torch.from_numpy(rd))


def test_sharded_search_declines_as_reference(small_pair):
    pseg, rseg = small_pair
    pack = sharded.ShardedPack(pseg, cpu_mesh(4))
    stats = oracle.IndexStats([pseg])
    wide = should(*[f"w{i}" for i in range(17)])  # t_pad 64 > 16
    absent = should("nope")
    got = sharded.sharded_search_batch(pack, [wide, absent, should("w0")],
                                       stats, 4097)
    assert got == [None] * 3  # past the extraction ladder
    got = sharded.sharded_search_batch(pack, [wide, absent], stats, 10)
    rpack = ref_sharded.ShardedPack(rseg, ref_sharded.make_mesh(4))
    rstats = fugu_tpu.ops.oracle.IndexStats([rseg])
    want = [ref_sharded.sharded_search(rpack, to_ref_plan(p), rstats, 10)
            for p in (wide, absent)]
    assert got == want == [None, None]


# -- tests/test_pallas_sharded.py: the block scorer per shard -------------------


def pallas_docs():
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(40)]
    return [({"text": [" ".join(rng.choice(words, size=int(rng.integers(3, 20))))]},
             [f"/cat/{int(rng.integers(0, 5))}"]) for _ in range(2500)]


@pytest.fixture(scope="module")
def block_pair():
    return pair(pallas_docs(), tomb=slice(None, None, 83))


PLANS = [
    should("w0", "w1", "w2"),
    QueryPlan(groups=(
        QueryGroup(Occur.MUST, (TermClause("text", "w3"),)),
        QueryGroup(Occur.SHOULD, (TermClause("text", "w4"),)),
        QueryGroup(Occur.MUST_NOT, (TermClause("text", "w5"),)),
        QueryGroup(Occur.MUST, (facet("/cat/1"),)),
    )),
    should("w7"),
    must("w0", "w1"),
]


@pytest.mark.parametrize("n_slices", [1, 2])
def test_block_sharded_matches_reference(block_pair, n_slices):
    pseg, rseg = block_pair
    stats = oracle.IndexStats([pseg])
    got = bksh.block_sharded_search_batch(
        bksh.BlockShardedPack(pseg, cpu_mesh(8, n_slices)), PLANS, stats, 10)
    want = ref_psh.pallas_sharded_search_batch(
        ref_psh.PallasShardedPack(rseg, ref_sharded.make_mesh(8, n_slices)),
        [to_ref_plan(p) for p in PLANS],
        fugu_tpu.ops.oracle.IndexStats([rseg]), 10, interpret=True)
    for plan, g, w in zip(PLANS, got, want):
        assert key(g) == key(w) == expect(pseg, plan, 10)


def test_block_sharded_one_shard_holds_every_block(block_pair, monkeypatch):
    """A 1-shard mesh: the shard holds every block of the segment, and
    its row of a head term lists them all in one launch (the reference
    splits such a shard into block-slice rows; both equal the oracle)."""
    pseg, rseg = block_pair
    calls = []
    orig = block_scorer.score_rows

    def spy(*args):
        calls.append(args)
        return orig(*args)

    monkeypatch.setattr(block_scorer, "score_rows", spy)
    pack = bksh.BlockShardedPack(pseg, cpu_mesh(1))
    assert pack.n_blocks[0] > 1
    stats = oracle.IndexStats([pseg])
    got = bksh.block_sharded_search_batch(pack, PLANS, stats, 10)
    assert max(int(a[0].max()) for a in calls) == pack.n_blocks[0]
    monkeypatch.setattr(ref_psh, "NB_BUCKETS", (1,))
    want = ref_psh.pallas_sharded_search_batch(
        ref_psh.PallasShardedPack(rseg, ref_sharded.make_mesh(1)),
        [to_ref_plan(p) for p in PLANS],
        fugu_tpu.ops.oracle.IndexStats([rseg]), 10, interpret=True)
    for plan, g, w in zip(PLANS, got, want):
        assert key(g) == key(w) == expect(pseg, plan, 10)


def test_block_sharded_declines_as_reference(block_pair):
    """Limits past 128, nonpositive weights and over-wide plans are left
    to the caller; a plan whose every clause has df 0 is exactly []."""
    pseg, _rseg = block_pair
    pack = bksh.BlockShardedPack(pseg, cpu_mesh(4))
    stats = oracle.IndexStats([pseg])
    assert bksh.block_sharded_search_batch(pack, PLANS, stats, 129) == [
        None] * len(PLANS)
    wide = should(*[f"w{i}" for i in range(17)])
    got = bksh.block_sharded_search_batch(
        pack, [wide, should("nope"), phrase(["w1", "w2"])], stats, 10)
    assert got == [None, [], None]


# -- tests/test_batch_sharded.py: the two-phase engine per shard ----------------


def batch_docs():
    rng = np.random.default_rng(21)
    words = [f"w{i}" for i in range(40)]
    return [({"text": [" ".join(rng.choice(words, size=int(rng.integers(3, 20))))]},
             [f"/cat/{int(rng.integers(0, 5))}"]) for _ in range(6000)]


@pytest.fixture(scope="module")
def batch_pair():
    return pair(batch_docs(), tomb=slice(None, None, 67))


def make_plans(rng, n):
    """tests/test_batch_sharded.py's mix: pure SHOULD, intersections and
    facet-filtered plans, half of those with require_should."""
    plans = []
    for _ in range(n):
        kind = rng.random()
        t = rng.choice(40, size=int(rng.integers(1, 4)), replace=False)
        if kind < 0.5:
            plans.append(should(*[f"w{x}" for x in t]))
        elif kind < 0.75:
            plans.append(must(*[f"w{x}" for x in t]))
        else:
            groups = [QueryGroup(Occur.SHOULD, (TermClause("text", f"w{x}"),))
                      for x in t]
            groups.append(QueryGroup(Occur.MUST, (
                facet(f"/cat/{int(rng.integers(0, 5))}"),)))
            plans.append(QueryPlan(groups=tuple(groups),
                                   require_should=bool(rng.random() < 0.5)))
    return plans


def two_phase_both(pseg, rseg, n_dev, n_slices, plans, limits):
    """(port results, reference results) of the sharded two-phase
    engine on the same plans."""
    stats = oracle.IndexStats([pseg])
    mesh = cpu_mesh(n_dev, n_slices)
    got = bsh.batch_search_sharded(
        bsh.ShardedBlockMajor(pseg, mesh, stats),
        bksh.BlockShardedPack(pseg, mesh), plans, stats, limits)
    rmesh = ref_sharded.make_mesh(n_dev, n_slices=n_slices)
    rstats = fugu_tpu.ops.oracle.IndexStats([rseg])
    want = ref_bsh.batch_search_sharded(
        ref_bsh.ShardedBlockMajor(rseg, rmesh, rstats),
        ref_psh.PallasShardedPack(rseg, rmesh),
        [to_ref_plan(p) for p in plans], rstats, limits, interpret=True)
    return got, want


@pytest.mark.parametrize("n_dev,n_slices", [(2, 1), (4, 1), (4, 2)])
def test_two_phase_sharded_matches_reference(batch_pair, n_dev, n_slices):
    pseg, rseg = batch_pair
    rng = np.random.default_rng(5)
    plans = make_plans(rng, 20)
    limits = [int(rng.choice([5, 10])) for _ in plans]
    got, want = two_phase_both(pseg, rseg, n_dev, n_slices, plans, limits)
    assert [g is None for g in got] == [w is None for w in want]
    assert sum(g is not None for g in got) >= len(plans) // 2
    for plan, lim, g, w in zip(plans, limits, got, want):
        if g is not None:
            assert key(g) == key(w) == expect(pseg, plan, lim)


def test_two_phase_sharded_packed_and_merged_streams(batch_pair, monkeypatch):
    """Count lanes packed two queries a lane (``_PACK_MIN_B`` lowered so
    a 64-lane stream packs; the reference forces it by its environment)
    and narrow and wide streams merged: results equal the reference's
    and the oracle."""
    pseg, rseg = batch_pair
    monkeypatch.setattr(batch_scorer, "_PACK_MIN_B", 64)
    monkeypatch.setenv("FUGU_PACK_COUNTS", "force")
    orders = []
    orig = batch_scorer._pack_order

    def spy(q_idx, plans, tid_of, half):
        out = orig(q_idx, plans, tid_of, half)
        orders.append(out)
        return out

    monkeypatch.setattr(batch_scorer, "_pack_order", spy)
    rng = np.random.default_rng(11)
    plans = []
    for _ in range(24):
        t = [f"w{x}" for x in rng.choice(12, size=int(rng.integers(2, 4)),
                                         replace=False)]
        r = rng.random()
        if r < 0.4:
            plans.append(should(*t))
        elif r < 0.8:
            plans.append(must(*t))
        else:
            plans.append(QueryPlan(groups=tuple(
                QueryGroup(Occur.MUST, (TermClause("text", w),))
                for w in t[:-1]
            ) + (QueryGroup(Occur.MUST_NOT, (TermClause("text", t[-1]),)),)))
    limits = [int(rng.choice([5, 10])) for _ in plans]
    got, want = two_phase_both(pseg, rseg, 4, 1, plans, limits)
    assert any(o is not None for o in orders), "packing never engaged"
    assert sum(g is not None for g in got) >= len(plans) // 2
    for plan, lim, g, w in zip(plans, limits, got, want):
        if g is not None:
            assert key(g) == expect(pseg, plan, lim)
            if w is not None:
                assert key(g) == key(w)


def test_two_phase_sharded_declines_upper_and_nonpositive(batch_pair):
    """"upper"-kind plans (a multi-clause MUST group) and plans with a
    nonpositive weight come back None, as in the reference."""
    pseg, _rseg = batch_pair
    upper = QueryPlan(groups=(
        QueryGroup(Occur.MUST, (TermClause("text", "w1"),
                                TermClause("text", "w2"))),))
    assert batch_scorer._classify(upper) == "upper"
    # four fifths dead: w0's df passes the live doc count
    dead = dataclasses.replace(
        pseg, tombstones=np.arange(pseg.doc_count) % 5 != 0,
        _device_pack=None)
    assert has_nonpositive_weight(should("w0"), oracle.IndexStats([dead]))
    for seg, plan in ((pseg, upper), (dead, should("w0"))):
        stats = oracle.IndexStats([seg])
        mesh = cpu_mesh(2)
        got = bsh.batch_search_sharded(
            bsh.ShardedBlockMajor(seg, mesh, stats),
            bksh.BlockShardedPack(seg, mesh), [plan], stats, [10])
        assert got == [None]


# -- tests/test_phrase_sharded.py: the phrase kernel per shard ------------------


def phrase_docs():
    rng = np.random.default_rng(31)
    words = [f"w{i}" for i in range(30)]
    docs = []
    # 5003 docs: an odd count, so the 8-way (s*n)//d split puts uneven
    # ranges on shards and block tails hit shard bounds
    for i in range(5003):
        text = " ".join(rng.choice(words, size=int(rng.integers(4, 26))))
        vals = [text]
        if i % 9 == 0:
            vals = [text, " ".join(rng.choice(words, size=5))]
        docs.append(({"text": vals}, []))
    # one long doc spanning chunks, near a shard boundary by id
    docs.append(({"text": [" ".join(["w1 w2"] * 1200)]}, []))
    return docs


@pytest.fixture(scope="module")
def phrase_pair():
    return pair(phrase_docs(), tomb=slice(None, None, 41))


def phrase_both(pseg, rseg, plans, limits, n=8):
    got = phsh.batch_phrase_search_sharded(
        pseg, cpu_mesh(n), plans, oracle.IndexStats([pseg]), limits)
    want = ref_phsh.batch_phrase_search_sharded(
        rseg, ref_sharded.make_mesh(n), [to_ref_plan(p) for p in plans],
        fugu_tpu.ops.oracle.IndexStats([rseg]), limits, interpret=True)
    return got, want


def test_sharded_phrase_parity(phrase_pair):
    pseg, rseg = phrase_pair
    rng = np.random.default_rng(3)
    plans, limits = [], []
    for _ in range(20):
        w = rng.integers(0, 30, size=2)
        plans.append(phrase([f"w{w[0]}", f"w{w[1]}"]))
        limits.append(int(rng.choice([3, 10, 50])))
    got, want = phrase_both(pseg, rseg, plans, limits)
    for plan, lim, g, w in zip(plans, limits, got, want):
        assert g is not None, plan
        assert key(g) == key(w) == expect(pseg, plan, lim), plan


def test_sharded_phrase_slop_boost_and_lengths(phrase_pair):
    pseg, rseg = phrase_pair
    plans = [
        phrase(["w1"]),
        phrase(["w1", "w2", "w3"]),
        phrase(["w1", "w3"], slop=1),
        phrase(["w2", "w4"], slop=2, boost=1.7),
        phrase(["w0", "zz-absent"]),
        phrase(["w5", "w6"], occur=Occur.MUST),
    ]
    limits = [5, 10, 10, 10, 10, 100]
    got, want = phrase_both(pseg, rseg, plans, limits)
    for plan, lim, g, w in zip(plans, limits, got, want):
        assert g is not None, plan
        assert key(g) == key(w) == expect(pseg, plan, lim), plan
    assert got[4] == []


def test_sharded_phrase_matches_single_device(phrase_pair):
    """The sharded engine and the single-device stream engine agree
    exactly, and so do the reference's sharded and single-chip ones."""
    pseg, rseg = phrase_pair
    plans = [phrase([f"w{i}", f"w{(i + 3) % 30}"]) for i in range(10)]
    limits = [10] * len(plans)
    got, want = phrase_both(pseg, rseg, plans, limits)
    single = phrase_stream.batch_phrase_search(
        pseg, plans, oracle.IndexStats([pseg]), limits, torch.device("cpu"))
    ref_single = ref_phrase_stream.batch_phrase_search(
        rseg, [to_ref_plan(p) for p in plans],
        fugu_tpu.ops.oracle.IndexStats([rseg]), limits, interpret=True)
    for plan, a, b, c, d in zip(plans, got, single, want, ref_single):
        assert a is not None and b is not None
        assert key(a) == key(b) == key(c) == key(d), plan


def test_sharded_phrase_tombstones_and_long_doc(phrase_pair):
    pseg, rseg = phrase_pair
    plan = phrase(["w1", "w2"])
    got, want = phrase_both(pseg, rseg, [plan], [3])
    assert key(got[0]) == key(want[0]) == expect(pseg, plan, 3)
    assert got[0][0][1] == pseg.doc_count - 1  # the long doc tops on tf
    dead = set(np.nonzero(pseg.tombstones)[0].tolist())
    assert not ({d for _s, d in got[0]} & dead)


@pytest.mark.parametrize("n", [3, 8])
def test_shard_doc_rows_address_each_token(phrase_pair, n):
    """Per shard, ``stream_doc_rows`` over the shard's doc range, read
    through the kernel's pack addressing, gives back each live doc's
    tokens at their positions, and each doc owns maxpos + 1 + KGAP rows
    (none when tombstoned): the table the kernel walks on the card,
    which the plain version does not read."""
    pseg, _rseg = phrase_pair
    stats = oracle.IndexStats([pseg])
    offs = pseg.pos_offsets["text"]
    base = pseg.field_entry_base["text"]
    lens = np.diff(offs).astype(np.int64)
    docs = np.repeat(pseg.e_doc[base:base + len(lens)].astype(np.int64), lens)
    pos = pseg.pos_data["text"][: int(offs[-1])].astype(np.int64)
    terms = pseg.terms["text"]
    tid_entry = np.zeros(len(lens), dtype=np.int64)
    for j, info in enumerate(terms.values()):
        tid_entry[info.start - base:info.start - base + info.doc_freq] = j
    tids = np.repeat(tid_entry, lens)
    bounds = sharded.shard_bounds(pseg.doc_count, n)
    blk_docs = phrase_stream.BM_BLOCK_DOCS
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        arrs = phrase_stream.build_stream_arrays(pseg, "text", stats,
                                                 doc_lo=lo, doc_hi=hi)
        doc_row = phrase_stream.stream_doc_rows(pseg, "text", arrs.nb_pad,
                                                lo, hi)
        sel = (docs >= lo) & (docs < hi) & ~pseg.tombstones[docs]
        local = docs[sel] - lo
        blk, within = local // blk_docs, local % blk_docs
        at = _pack_index(arrs.chunk_offs, blk, doc_row[blk, within] + pos[sel])
        np.testing.assert_array_equal(
            arrs.pack[at],
            (within << phrase_stream.TID_BITS | tids[sel]).astype(np.int32))
        maxpos = np.full(hi - lo, -1)
        in_range = (docs >= lo) & (docs < hi)
        np.maximum.at(maxpos, docs[in_range] - lo, pos[in_range])
        d = np.arange(hi - lo)
        n_rows = (doc_row[d // blk_docs, d % blk_docs + 1]
                  - doc_row[d // blk_docs, d % blk_docs])
        dead = pseg.tombstones[lo:hi] | (maxpos < 0)
        np.testing.assert_array_equal(
            n_rows, np.where(dead, 0, maxpos + 1 + phrase_stream.KGAP))


def test_sharded_phrase_residency_registered(phrase_pair):
    pseg, _rseg = phrase_pair
    phsh.batch_phrase_search_sharded(
        pseg, cpu_mesh(8), [phrase(["w1", "w2"])],
        oracle.IndexStats([pseg]), [5])
    assert residency.stats()["by_kind"].get("token_stream", 0) > 0


def test_sharded_stream_evicted_then_reserved(phrase_pair, monkeypatch):
    """Evicting the sharded token stream (budget pressure) drops the
    cache, so the next search re-uploads and re-registers it, and the
    results stay bit-identical across the cycle."""
    pseg, _rseg = phrase_pair
    mesh = cpu_mesh(8)
    stats = oracle.IndexStats([pseg])
    plans = [phrase(["w1", "w2"]), phrase(["w2", "w3"], slop=1)]
    first = phsh.batch_phrase_search_sharded(pseg, mesh, plans, stats, [5, 5])
    rkey = ("stok", id(pseg), "text")
    assert residency.contains(rkey)
    # LRU pressure: a tiny budget evicts everything resident
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", "1")
    residency.reserve(("probe", 0), 1, pseg, lambda _o: None, kind="probe")
    assert not residency.contains(rkey)
    assert getattr(pseg, "_sharded_token_stream", {}) == {}
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", "auto")
    residency.unregister(("probe", 0))
    second = phsh.batch_phrase_search_sharded(pseg, mesh, plans, stats, [5, 5])
    assert first == second
    assert residency.contains(rkey)


# -- the port's own cases -------------------------------------------------------


def every_engine(pseg, mesh, plan, limit):
    """The plan through every sharded engine on ``mesh``: the small-
    segment engine, the block scorer, the two-phase engine and, for a
    phrase, the phrase kernel."""
    stats = oracle.IndexStats([pseg])
    if plan.host_only:
        return {"phrase": phsh.batch_phrase_search_sharded(
            pseg, mesh, [plan], stats, [limit])[0]}
    pack = bksh.BlockShardedPack(pseg, mesh)
    return {
        "small": sharded.sharded_search(pack, plan, stats, limit),
        "block": bksh.block_sharded_search_batch(pack, [plan], stats,
                                                 limit)[0],
        "two_phase": bsh.batch_search_sharded(
            bsh.ShardedBlockMajor(pseg, mesh, stats), pack, [plan], stats,
            [limit])[0],
    }


@pytest.mark.parametrize("n_slices", [1, 2])
@pytest.mark.parametrize("plan", [should("tie"), phrase(["tie", "word"])],
                         ids=["term", "phrase"])
def test_ties_across_shard_bounds(plan, n_slices):
    """40 identical docs on 4 shards (bounds 0, 10, 20, 30, 40): equal
    scores come out doc-ascending across the bounds, as the oracle and
    the reference order them."""
    pseg, rseg = pair([({"text": ["tie word tie"]}, ["/cat/0"])] * 40)
    mesh = cpu_mesh(4, n_slices)
    want = expect(pseg, plan, 15)
    assert [d for _s, d in want] == list(range(15))
    rmesh = ref_sharded.make_mesh(4, n_slices=n_slices)
    rstats = fugu_tpu.ops.oracle.IndexStats([rseg])
    if plan.host_only:
        ref = ref_phsh.batch_phrase_search_sharded(
            rseg, rmesh, [to_ref_plan(plan)], rstats, [15],
            interpret=True)[0]
    else:
        ref = ref_psh.pallas_sharded_search_batch(
            ref_psh.PallasShardedPack(rseg, rmesh), [to_ref_plan(plan)],
            rstats, 15, interpret=True)[0]
    assert key(ref) == want
    for engine, got in every_engine(pseg, mesh, plan, 15).items():
        assert key(got) == want, engine


def test_two_dimensional_merge_equals_flat_merge():
    """merge_topk on a 2x2 mesh (each slice first, then the slices)
    equals the flat merge over 4 shards and a sort of every candidate by
    (score descending, doc ascending), ties and missing shards
    included."""
    rng = np.random.default_rng(0)
    scores, docs = [], []
    for s in range(4):
        sc = np.sort(rng.choice([1.0, 2.0, 2.5, 3.0], size=(5, 6)))[:, ::-1]
        sc = np.ascontiguousarray(sc, dtype=np.float32)
        sc[s % 5, 3:] = -np.inf  # a row with fewer hits
        d = np.sort(rng.choice(1000, size=(5, 6), replace=False) + s * 1000)
        d = np.where(np.isfinite(sc), d, 2**31 - 1).astype(np.int32)
        scores.append(torch.from_numpy(sc))
        docs.append(torch.from_numpy(d))
    scores[2], docs[2] = None, None  # a shard with no candidates
    flat = sharded.merge_topk(cpu_mesh(4), scores, docs, 8)
    two_d = sharded.merge_topk(cpu_mesh(4, 2), scores, docs, 8)
    assert torch.equal(flat[0], two_d[0]) and torch.equal(flat[1], two_d[1])
    for row in range(5):
        cand = sorted(
            (-float(s[row, j]), int(d[row, j]))
            for s, d in zip(scores, docs) if s is not None
            for j in range(s.shape[1]) if np.isfinite(float(s[row, j])))[:8]
        got = [(-float(s), int(d)) for s, d in zip(flat[0][row], flat[1][row])
               if np.isfinite(float(s))]
        assert got == cand
    assert sharded.merge_topk(cpu_mesh(2), [None, None], [None, None], 4) is None


def test_more_shards_than_docs():
    """3 docs on 8 shards: the empty shards give empty local results and
    launch nothing; every engine equals the oracle."""
    docs = [({"text": [t]}, ["/cat/0"]) for t in
            ("alpha beta gamma", "beta gamma", "gamma alpha beta")]
    pseg, _rseg = pair(docs)
    mesh = cpu_mesh(8)
    assert sharded.shard_bounds(3, 8) == [0, 0, 0, 1, 1, 1, 2, 2, 3]
    for plan in (should("beta"), must("alpha", "beta"),
                 phrase(["beta", "gamma"])):
        for engine, got in every_engine(pseg, mesh, plan, 10).items():
            assert key(got) == expect(pseg, plan, 10), (engine, plan)


def test_residency_of_a_one_device_mesh_counts_every_shard(block_pair,
                                                          tmp_path):
    """On one device the residency books hold every shard's bytes of the
    sharded entry pack, block-major pack and token stream (the
    reference's per-chip share would count a quarter of them)."""
    from fugu_tpu_torch.engine.named_index import NamedIndex
    from fugu_tpu_torch.index.schema import IndexType

    pseg, _rseg = block_pair
    residency.reset_for_test()
    try:
        ni = NamedIndex("res", tmp_path, IndexType.DOCS, device="cpu")
        mesh = cpu_mesh(4)
        ni.enable_sharding(mesh)
        stats = oracle.IndexStats([pseg])
        pack = ni._sharded_pack(pseg, mesh)
        bm = ni._sharded_block_major(pseg, stats, mesh)
        stream = phsh.get_sharded_token_stream(pseg, "text", mesh, stats)

        def nbytes(tensors):
            return sum(t.numel() * t.element_size() for t in tensors)

        by_kind = residency.stats()["by_kind"]
        assert by_kind["sharded_pack"] == nbytes(
            t for p in pack.packs for t in (p.e_doc, p.e_tffid, p.tomb))
        assert by_kind["sharded_block_major"] == nbytes(
            t for p in bm.packs for t in p)
        assert by_kind["token_stream"] == nbytes(
            t for sh in stream.shards for t in sh)
        assert len(pack.packs) == 4 and by_kind["sharded_pack"] == (
            pack.device_bytes[torch.device("cpu")])
        # a second call hits the caches
        assert ni._sharded_pack(pseg, mesh) is pack
        assert ni._sharded_block_major(pseg, stats, mesh) is bm
    finally:
        residency.reset_for_test()


def test_make_mesh_layout():
    mesh = cpu_mesh(8, 2)
    assert mesh.axis_names == ("dcn", "d") and mesh.shape == (2, 4)
    assert sharded.shard_axes(mesh) == ("dcn", "d")
    assert mesh.size == 8 and mesh.root == torch.device("cpu")
    assert cpu_mesh(3).shape == (3,) and cpu_mesh(3).axis_names == ("d",)
    assert sharded.make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="not divisible"):
        cpu_mesh(6, 4)
    with pytest.raises(ValueError):
        sharded.make_mesh(2, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sharded.make_mesh(2)
    for n in (1, 5, 16):
        for d in (1, 2, 3, 8):
            assert sharded.shard_bounds(n, d) == ref_sharded.shard_bounds(n, d)


def test_dryrun_multichip_on_cpu():
    from fugu_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(4, "cpu")
    assert out["two_phase_handled"] == out["plans"]
    assert out["phrases_served"] == 10


def test_parallel_imports_no_jax_fugu_tpu_or_triton():
    code = (
        "import sys\n"
        "import fugu_tpu_torch.parallel.sharded, "
        "fugu_tpu_torch.parallel.block_sharded, "
        "fugu_tpu_torch.parallel.batch_sharded, "
        "fugu_tpu_torch.parallel.phrase_sharded, fugu_tpu_torch.dryrun, "
        "fugu_tpu_torch.engine.manager\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'fugu_tpu', 'triton'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
