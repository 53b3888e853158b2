"""The port's slice end to end: a namespace written by fugu_tpu, opened
by fugu_tpu_torch's NamedIndex, must answer search_topk_batch exactly as
the reference NamedIndex and the oracle do.  A fresh interpreter that
runs the slice must import neither JAX, nor fugu_tpu, nor Triton."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from fugu_tpu import query as ref_query
from fugu_tpu.engine.named_index import NamedIndex as RefNamedIndex
from fugu_tpu.index.schema import DOCS_SCHEMA, IndexType
from fugu_tpu.index.segment import SegmentBuilder as RefSegmentBuilder
from fugu_tpu.records import ObjectRecord
from fugu_tpu_torch import device as port_device
from fugu_tpu_torch.engine.named_index import NamedIndex
from fugu_tpu_torch.index.schema import DOCS_SCHEMA as PORT_DOCS_SCHEMA
from fugu_tpu_torch.index.schema import IndexType as PortIndexType
from fugu_tpu_torch.index.segment import SegmentBuilder
from fugu_tpu_torch.ops import oracle, residency

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
VOCAB = np.array([f"t{i:05d}" for i in range(400)])


def corpus_texts(n, seed):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.07
    p /= p.sum()
    lens = np.clip(rng.poisson(30, n), 3, 80)
    return [
        " ".join(rng.choice(VOCAB, size=int(ln), p=p)) for ln in lens
    ], rng.integers(0, 20, n)


def to_ref_plan(plan):
    """The same plan built from the reference's query classes."""
    def clause(c):
        return ref_query.TermClause(c.field, c.term, c.boost, c.is_facet)

    def phrase(ph):
        return ref_query.PhraseClause(ph.field, ph.terms, ph.boost, ph.slop)

    return ref_query.QueryPlan(
        groups=tuple(
            ref_query.QueryGroup(
                ref_query.Occur(g.occur.value),
                tuple(clause(c) for c in g.clauses),
                tuple(phrase(ph) for ph in g.phrases),
            )
            for g in plan.groups
        ),
        require_should=plan.require_should,
        k1=plan.k1,
        b=plan.b,
    )


@pytest.fixture(scope="module")
def namespace(tmp_path_factory):
    """Three committed segments written by the reference NamedIndex, with
    delete-by-id tombstones in the older two."""
    path = tmp_path_factory.mktemp("ns") / "docs"
    ni = RefNamedIndex("ns", path, IndexType.DOCS, compaction="off")
    for batch in range(3):
        texts, srcs = corpus_texts(1500, seed=batch)
        ni.upsert([
            ObjectRecord(id=f"d{batch}x{i}", text=t,
                         facets=[f"/source/{int(s)}"])
            for i, (t, s) in enumerate(zip(texts, srcs))
        ])
    for i in range(0, 1500, 41):
        ni.delete_document(f"d0x{i}")
        ni.delete_document(f"d1x{i + 7}")
    ni.close()
    return path, ni


def hits_key(hits):
    return [(np.float32(h.score), h.segment_ord, h.doc) for h in hits]


@pytest.mark.parametrize("limit", [10, 100])
def test_named_index_matches_reference_and_oracle(namespace, limit):
    path, ref = namespace
    port = NamedIndex("ns", path, PortIndexType.DOCS, device="cpu")
    assert len(port.segments) == 3
    assert port.num_docs == ref.num_docs
    mix = chip_smoke.make_query_mix(port.segments[0], n_queries=32)
    assert {cls for cls, _p, _l in mix} >= {
        "should", "must", "mustnot", "facet", "phrase", "limit100"}
    plans = [p for _c, p, _l in mix]
    got = port.search_topk_batch(plans, limit)
    # the reference's XLA engine compiles for about 15 s per limit on the
    # CPU, so it runs its device engines at limit 10 and its host chain
    # at limit 100 (its own tests hold both to the oracle)
    ref.use_device = limit == 10
    want = ref.search_topk_batch([to_ref_plan(p) for p in plans], limit)
    stats = port.stats()
    for p, g, w in zip(plans, got, want):
        exp = oracle.search(port.segments, p, limit, stats)
        assert hits_key(g) == hits_key(exp)
        assert hits_key(w) == hits_key(exp)
    # every engine of the hybrid chain took part
    assert port.routes["phase_a"] > 0 and port.routes["host_only"] > 0


def test_declined_plans_route_to_the_host_chain(namespace):
    """Plans the device engines decline by design (more than 16 clauses,
    limit above 128) take the host block-max engine or the oracle, and
    stay exact."""
    from fugu_tpu_torch.query import Occur, QueryGroup, QueryPlan, TermClause

    path, _ref = namespace
    port = NamedIndex("ns", path, PortIndexType.DOCS, device="cpu")
    wide = QueryPlan(groups=tuple(
        QueryGroup(Occur.SHOULD, (TermClause("text", f"t{i:05d}"),))
        for i in range(17)
    ))
    narrow = QueryPlan(groups=(
        QueryGroup(Occur.SHOULD, (TermClause("text", "t00003"),)),
    ))
    stats = port.stats()
    for plans, limit in (([wide, narrow], 10), ([narrow], 200)):
        got = port.search_topk_batch(plans, limit)
        for p, g in zip(plans, got):
            assert hits_key(g) == hits_key(
                oracle.search(port.segments, p, limit, stats))
    # per segment: the 17-clause plan, then the limit-200 plan
    assert port.routes["host"] == 2 * len(port.segments)


def test_stored_docs_and_tombstones_carry_over(namespace):
    path, ref = namespace
    port = NamedIndex("ns", path, PortIndexType.DOCS, device="cpu")
    for ps, rs in zip(port.segments, ref.segments):
        assert ps.segment_id == rs.segment_id
        np.testing.assert_array_equal(ps.tombstones, rs.tombstones)
        assert ps.stored[:5] == rs.stored[:5]
    assert port.segments[0].tombstones.sum() > 0


def test_segment_builder_matches_reference():
    """The port's SegmentBuilder (native tokenizer built into the port's
    own build directory) freezes the same segment as the reference's."""
    texts, srcs = corpus_texts(300, seed=9)
    segs = []
    for builder in (RefSegmentBuilder(DOCS_SCHEMA),
                    SegmentBuilder(PORT_DOCS_SCHEMA)):
        for t, s in zip(texts, srcs):
            builder.add_document({"text": [t]}, facets=[f"/source/{s}"],
                                 stored={"id": t[:8]})
        segs.append(builder.build())
    ref, port = segs
    for name in ("e_doc", "e_tf", "e_fid", "tombstones"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))

    def table(seg):
        return {f: {t: (i.start, i.doc_freq) for t, i in m.items()}
                for f, m in seg.terms.items()}

    assert table(port) == table(ref)


def test_delete_by_term_drops_device_tensors():
    texts, srcs = corpus_texts(200, seed=4)
    b = SegmentBuilder(PORT_DOCS_SCHEMA)
    for i, t in enumerate(texts):
        b.add_document({"id": [f"x{i}"], "text": [t]}, stored={"id": f"x{i}"})
    seg = b.build()
    stats = oracle.IndexStats([seg])
    cpu = torch.device("cpu")
    pack = seg.device_pack(cpu)
    assert seg.block_major(stats, cpu) is seg.block_major(stats, cpu)
    assert seg.device_tomb_flags(cpu) is pack.tomb
    assert int(pack.tomb[3]) == 0
    assert seg.delete_by_term("id", "x3") == 1
    assert seg._device_pack is None and seg._block_major is None
    assert int(seg.device_tomb_flags(cpu)[3]) == 1


def test_device_resolution_never_falls_back():
    assert port_device.resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert port_device.resolve("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            port_device.resolve("cuda")
        assert residency._auto_budget() is None
    with pytest.raises(ValueError):
        port_device.resolve("meta")


def test_slice_imports_no_jax_fugu_tpu_or_triton(namespace, tmp_path):
    """A fresh interpreter runs the port's slice on the CPU (build a
    segment, commit it, open it, search it) without importing JAX,
    fugu_tpu or Triton; the conftest of this suite imports JAX, hence
    the subprocess."""
    script = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        import chip_smoke
        from fugu_tpu_torch.engine.named_index import NamedIndex
        from fugu_tpu_torch.index.manifest import Manifest, save_segment
        from fugu_tpu_torch.index.schema import IndexType
        from fugu_tpu_torch.ops import oracle

        seg = chip_smoke.build_corpus(3000, 7, 500)
        seg.segment_id = "fresh"
        save_segment(seg, Path({str(tmp_path)!r}))
        Manifest({str(tmp_path)!r}).commit([seg])
        for path in ({str(tmp_path)!r}, {str(namespace[0])!r}):
            ni = NamedIndex("x", path, IndexType.DOCS, device="cpu")
            mix = chip_smoke.make_query_mix(ni.segments[0], n_queries=24)
            plans = [p for _c, p, _l in mix]
            got = ni.search_topk_batch(plans, 10)
            for p, g in zip(plans, got):
                exp = oracle.search(ni.segments, p, 10, ni.stats())
                assert [(h.score, h.doc) for h in g] == [
                    (h.score, h.doc) for h in exp]
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "fugu_tpu",
                                            "triton"))
        print("LOADED", bad)
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
