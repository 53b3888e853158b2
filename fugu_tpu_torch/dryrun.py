"""Dry run of doc-range sharding: one full sharded query step on an
``n``-shard mesh at a tiny size, every result held to the oracle.

``dryrun_multichip(4, "cuda")`` puts 4 shards on the CUDA card, which
then holds every shard; ``device="cpu"`` runs the kernels' plain
versions.  The steps are those of the reference's multi-chip dry run
(``_dryrun_body`` in ``__graft_entry__.py``):

1. the small-segment engine per shard (``sharded_search``);
2. the block scorer per shard on a batch of two plans;
3. the two-phase engine per shard on a mixed batch of at least
   ``MIN_BATCH`` plans, and the phrase kernel per shard on phrases with
   slop, boost and a MUST group;
4. on an even mesh of 4 or more, the same on the 2-D ("dcn", "d") mesh,
   whose merge is hierarchical;
5. ``Dataset.search_many`` over the mesh on an ingested namespace, terms
   and quoted phrases, with ``SMALL_SEGMENT_MAX_DOCS`` at the corpus size
   (the small-segment engine per shard) and at 0 (the two-phase engine per
   shard), each equal to an unsharded host-only dataset on the same
   directory.
"""

from __future__ import annotations

import tempfile

import numpy as np


def _tiny_segment(n_docs=64, vocab=16, seed=0):
    from fugu_tpu_torch.index.schema import DOCS_SCHEMA
    from fugu_tpu_torch.index.segment import SegmentBuilder

    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    b = SegmentBuilder(DOCS_SCHEMA)
    for i in range(n_docs):
        text = " ".join(rng.choice(words, size=int(rng.integers(3, 12))))
        b.add_document(
            {"text": [text]},
            facets=[f"/cat/{int(rng.integers(0, 3))}"],
            stored={"id": f"d{i}"},
        )
    return b.build()


def _mixed_plans(rng, seg, n_plans):
    """A production-shaped mixed batch: SHOULD / MUST / MUST_NOT / facet
    plans over the segment's real vocabulary."""
    from fugu_tpu_torch.query import Occur, QueryGroup, QueryPlan, TermClause

    terms = sorted(seg.terms["text"].keys())
    plans = []
    for i in range(n_plans):
        words = [terms[int(j)] for j in rng.choice(len(terms), size=3, replace=False)]
        cls = i % 4
        if cls == 0:
            groups = tuple(
                QueryGroup(Occur.SHOULD, (TermClause("text", w),)) for w in words
            )
        elif cls == 1:
            groups = tuple(
                QueryGroup(Occur.MUST, (TermClause("text", w),)) for w in words[:2]
            )
        elif cls == 2:
            groups = (
                QueryGroup(Occur.SHOULD, (TermClause("text", words[0]),)),
                QueryGroup(Occur.SHOULD, (TermClause("text", words[1]),)),
                QueryGroup(Occur.MUST_NOT, (TermClause("text", words[2]),)),
            )
        else:
            groups = (
                QueryGroup(Occur.SHOULD, (TermClause("text", words[0]),)),
                QueryGroup(
                    Occur.MUST,
                    (TermClause("", f"/cat/{i % 3}", is_facet=True),),
                ),
            )
        plans.append(QueryPlan(groups=groups))
    return plans


def dryrun_multichip(n_devices: int = 4, device: str = "cuda") -> dict:
    """Run steps 1-5 on an ``n_devices``-shard mesh on ``device``;
    raises AssertionError at the first result that differs from the
    oracle.  Returns counts of what each step served."""
    import torch

    from fugu_tpu_torch.engine import named_index
    from fugu_tpu_torch.engine.dataset import Dataset
    from fugu_tpu_torch.ops import oracle
    from fugu_tpu_torch.ops import phrase_stream as ps
    from fugu_tpu_torch.ops.batch_scorer import MIN_BATCH
    from fugu_tpu_torch.parallel.batch_sharded import (
        ShardedBlockMajor,
        batch_search_sharded,
    )
    from fugu_tpu_torch.parallel.block_sharded import (
        BlockShardedPack,
        block_sharded_search_batch,
    )
    from fugu_tpu_torch.parallel.phrase_sharded import (
        batch_phrase_search_sharded,
    )
    from fugu_tpu_torch.parallel.sharded import make_mesh, sharded_search
    from fugu_tpu_torch.query import (
        Occur, PhraseClause, QueryGroup, QueryPlan, TermClause,
    )
    from fugu_tpu_torch.records import ObjectRecord

    seg = _tiny_segment(n_docs=max(8 * n_devices, 64))
    stats = oracle.IndexStats([seg])
    mesh = make_mesh(n_devices, device=device)
    pack = BlockShardedPack(seg, mesh)
    plan = QueryPlan(
        groups=(
            QueryGroup(Occur.SHOULD, (TermClause("text", "w0"),)),
            QueryGroup(Occur.SHOULD, (TermClause("text", "w1"),)),
            QueryGroup(Occur.MUST_NOT, (TermClause("text", "w5"),)),
            QueryGroup(Occur.SHOULD, (TermClause("", "/cat/1", is_facet=True),)),
        )
    )
    plan2 = QueryPlan(
        groups=(
            QueryGroup(Occur.MUST, (TermClause("text", "w2"),)),
            QueryGroup(Occur.MUST, (TermClause("text", "w3"),)),
        )
    )

    def check(hits, p, seg_=None, stats_=None):
        """Exact parity: same docs, same f32 scores as the oracle."""
        s, st = seg_ or seg, stats_ or stats
        assert hits is not None and isinstance(hits, list)
        expected = oracle.search([s], p, 10, st)
        got = [(np.float32(sc), d) for sc, d in hits]
        want = [(np.float32(h.score), h.doc) for h in expected]
        assert got == want, (got, want)

    # 1) the small-segment engine per shard (per-plan path)
    check(sharded_search(pack, plan, stats, 10), plan)
    # 2) the batched block scorer per shard
    batch = block_sharded_search_batch(pack, [plan, plan2], stats, 10)
    check(batch[0], plan)
    check(batch[1], plan2)

    # 3) the two-phase engine per shard on a batch of at least MIN_BATCH
    rng = np.random.default_rng(5)
    big = _tiny_segment(n_docs=max(64 * n_devices, 1024), vocab=24, seed=9)
    big_stats = oracle.IndexStats([big])
    mixed = _mixed_plans(rng, big, max(MIN_BATCH + 4, 28))
    bpack2 = ShardedBlockMajor(big, mesh, big_stats)
    bspack = BlockShardedPack(big, mesh)
    res = batch_search_sharded(
        bpack2, bspack, mixed, big_stats, [10] * len(mixed)
    )
    handled = sum(r is not None for r in res)
    assert handled >= len(mixed) * 3 // 4, (
        f"two-phase sharded engine handled only {handled}/{len(mixed)}"
    )
    for p, r in zip(mixed, res):
        if r is not None:
            check(r, p, big, big_stats)

    # 3b) the phrase class on the same mesh, slop, boost and MUST shapes
    # included (on a card a field's batch needs PHRASE_MIN_BATCH phrases)
    def phrase_plan(words, occur=Occur.SHOULD, slop=0, boost=1.0):
        return QueryPlan(groups=(QueryGroup(occur, phrases=(
            PhraseClause("text", tuple(words), boost=boost, slop=slop),)),))

    bterms = sorted(big.terms["text"].keys())
    phr = [
        phrase_plan(bterms[:2]),
        phrase_plan(bterms[2:5]),
        phrase_plan(bterms[1:3], slop=1),
        phrase_plan(bterms[3:5], slop=2, boost=1.5),
        phrase_plan(bterms[:2], occur=Occur.MUST),
    ] + [phrase_plan(bterms[i:i + 2]) for i in range(5, 10)]
    phr_res = batch_phrase_search_sharded(
        big, mesh, phr, big_stats, [10] * len(phr)
    )
    phr_served = sum(r is not None for r in phr_res)
    assert phr_served == len(phr), (
        f"sharded phrase stream served only {phr_served}/{len(phr)}"
    )
    for p, r in zip(phr, phr_res):
        check(r, p, big, big_stats)

    # 4) the 2-D ("dcn", "d") mesh: hierarchical merge
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2d = make_mesh(n_devices, n_slices=2, device=device)
        pack2d = BlockShardedPack(seg, mesh2d)
        batch2d = block_sharded_search_batch(pack2d, [plan, plan2], stats, 10)
        check(batch2d[0], plan)
        check(batch2d[1], plan2)
        b2d = ShardedBlockMajor(big, mesh2d, big_stats)
        s2d = BlockShardedPack(big, mesh2d)
        res2d = batch_search_sharded(
            b2d, s2d, mixed, big_stats, [10] * len(mixed)
        )
        for p, r in zip(mixed, res2d):
            if r is not None:
                check(r, p, big, big_stats)

    # 5) the full engine path over the mesh: ingest -> search_many, on a
    # corpus above DEVICE_MIN_ENTRIES so the sharded engines serve it;
    # the phrase stream forced by the cost model's host constant
    queries = [
        (f"mesh w{i % 16} w{(i * 5) % 16}", [])
        for i in range(max(MIN_BATCH + 2, 26))
    ] + [
        (f'"w{i % 16} w{(i * 3) % 16}"', []) for i in range(10)
    ] + [('"mesh doc"~1', [])]
    routes = {}
    host_cost = ps.HOST_NS_PER_MIN_POSTING
    small_max = named_index.SMALL_SEGMENT_MAX_DOCS
    with tempfile.TemporaryDirectory() as tmp:
        records = [
            ObjectRecord(
                id=f"d{i}",
                text=f"w{i % 16} w{(i * 3) % 16} w{(i * 7) % 16} "
                f"w{(i * 11) % 16} mesh doc common",
                namespace="dryrun",
            )
            for i in range(max(96 * n_devices, 1024))
        ]
        ds = Dataset("dryrun", tmp, device=device)
        ds.ingest(records)
        ds.docs().enable_sharding(mesh)
        ds_host = Dataset("dryrun", tmp, use_device=False)
        want = ds_host.search_many(queries, 0, 5)
        ps.HOST_NS_PER_MIN_POSTING = 1e9
        try:
            for engine, constant in (("small", len(records)),
                                     ("two-phase", 0)):
                named_index.SMALL_SEGMENT_MAX_DOCS = constant
                ds.docs().routes.clear()
                got = ds.search_many(queries, 0, 5)
                routes[engine] = dict(ds.docs().routes)
                for q, g, w in zip(queries, got, want):
                    assert [(r.id, np.float32(r.score)) for r in g] == [
                        (r.id, np.float32(r.score)) for r in w
                    ], (engine, q, g, w)
        finally:
            ps.HOST_NS_PER_MIN_POSTING = host_cost
            named_index.SMALL_SEGMENT_MAX_DOCS = small_max
            ds.close()
            ds_host.close()
    assert routes["small"].get("sharded_small", 0) > 0, routes
    assert routes["two-phase"].get("sharded_phase_a", 0) > 0, routes
    for r in routes.values():
        assert r.get("phrase_stream_sharded", 0) > 0, routes
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return {
        "shards": n_devices, "two_phase_handled": handled,
        "plans": len(mixed), "phrases_served": phr_served,
        "engine_routes": routes,
    }

