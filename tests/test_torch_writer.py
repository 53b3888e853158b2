"""The port's writer side against the reference's: upsert, delete,
commit, compaction (background, sync, off, forced), spill and restore.

Every scenario runs on the reference (``use_device=False``: its host
engines) and on the port (``device="cpu"``, where the device engine and
the device merge run their plain PyTorch versions), and the two must
agree: segment by segment the same doc counts, tombstones and posting
arrays, and hits bit-identical to each other and to the oracle after
every step.  A namespace directory written by either package opens in
the other.  The reference's own cases of tests/test_compactor.py and
the filesystem cases of tests/test_storage.py are ported below, each
run on both packages."""

import dataclasses
import shutil
import threading
import types

import numpy as np
import pytest
import torch

import chip_smoke
import fugu_tpu.config
import fugu_tpu.engine.dataset
import fugu_tpu.engine.manager
import fugu_tpu.engine.named_index
import fugu_tpu.engine.queryparser
import fugu_tpu.index.compactor
import fugu_tpu.index.merge
import fugu_tpu.index.schema
import fugu_tpu.ops.oracle
import fugu_tpu.query
import fugu_tpu.records
import fugu_tpu.storage.spill
import fugu_tpu.telemetry
import fugu_tpu_torch.config
import fugu_tpu_torch.engine.dataset
import fugu_tpu_torch.engine.manager
import fugu_tpu_torch.engine.named_index
import fugu_tpu_torch.engine.queryparser
import fugu_tpu_torch.index.compactor
import fugu_tpu_torch.index.merge
import fugu_tpu_torch.index.schema
import fugu_tpu_torch.ops.oracle
import fugu_tpu_torch.query
import fugu_tpu_torch.records
import fugu_tpu_torch.storage.spill
import fugu_tpu_torch.telemetry
from fugu_tpu_torch.index.schema import IndexType
from fugu_tpu_torch.ops import device_merge, oracle, residency
from test_storage import _FakeS3Client
from test_torch_slice import hits_key, to_ref_plan

torch.set_num_threads(1)


def _package(root, name, kw, mgr_kw):
    """One package's classes and modules under common names; ``kw`` and
    ``mgr_kw`` are its NamedIndex/Dataset and DatasetManager keyword
    arguments."""
    return types.SimpleNamespace(
        name=name, kw=kw, mgr_kw=mgr_kw,
        NamedIndex=root.engine.named_index.NamedIndex,
        Dataset=root.engine.dataset.Dataset,
        ObjectRecord=root.records.ObjectRecord,
        IndexType=root.index.schema.IndexType,
        LogMergePolicy=root.index.compactor.LogMergePolicy,
        BackgroundCompactor=root.index.compactor.BackgroundCompactor,
        merge_segments=root.index.merge.merge_segments,
        parse=root.engine.queryparser.parse_with_fallback,
        spill=root.storage.spill, config=root.config,
        dataset=root.engine.dataset, manager=root.engine.manager,
        oracle=root.ops.oracle, query=root.query,
        named_index_module=root.engine.named_index, telemetry=root.telemetry,
    )


PORT = _package(fugu_tpu_torch, "port", {"device": "cpu"}, {"device": "cpu"})
REF = _package(fugu_tpu, "ref", {"use_device": False}, {"use_device": False})
PKGS = [PORT, REF]

VOCAB = np.array([f"t{i:05d}" for i in range(400)])


@pytest.fixture(autouse=True)
def _clean_residency():
    residency.reset_for_test()
    yield
    residency.reset_for_test()


def record_specs(rng, ids):
    """(id, text, facet) triples: Zipf text over 400 terms, about 55
    tokens a doc, so that 160 docs make more than DEVICE_MIN_ENTRIES
    postings; one of 8 facet sources."""
    p = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.07
    p /= p.sum()
    return [
        (f"d{i}", " ".join(rng.choice(VOCAB, size=int(rng.integers(40, 70)),
                                      p=p)), f"/source/{int(rng.integers(8))}")
        for i in ids
    ]


def records(pkg, specs):
    return [pkg.ObjectRecord(id=i, text=t, facets=[f]) for i, t, f in specs]


def seg_state(seg):
    terms = {f: {t: (i.start, i.doc_freq) for t, i in m.items()}
             for f, m in seg.terms.items()}
    return (seg.doc_count, seg.n_entries, seg.tombstones.tolist(),
            seg.e_doc.tolist(), seg.e_tf.tolist(), seg.e_fid.tolist(),
            terms, seg.stored)


def assert_same_index(port, ref):
    assert len(port.segments) == len(ref.segments)
    for ps, rs in zip(port.segments, ref.segments):
        assert seg_state(ps) == seg_state(rs)
    assert port.num_docs == ref.num_docs
    # segment ids are random: compare the cold entries without them
    def cold(ni):
        return sorted((e["doc_count"], e["live_docs"])
                      for e in ni.cold_segments.values())

    assert cold(port) == cold(ref)


def assert_same_hits(port, ref, plans, limit=10):
    """Port hits == reference hits == the oracle's, bit for bit."""
    got = port.search_topk_batch(plans, limit)
    want = ref.search_topk_batch([to_ref_plan(p) for p in plans], limit)
    stats = port.stats()
    for p, g, w in zip(plans, got, want):
        exp = hits_key(oracle.search(port.segments, p, limit, stats))
        assert hits_key(g) == exp
        assert hits_key(w) == exp


def query_plans(seg):
    plans = [p for _c, p, _l in chip_smoke.make_query_mix(seg, n_queries=64)]
    return plans + [chip_smoke.phrase_plan(["t00001", "t00002"])]


def _index(pkg, path, compaction):
    return pkg.NamedIndex("docs", path, pkg.IndexType.DOCS,
                          compaction=compaction, **pkg.kw)


def open_pair(tmp_path, compaction, **policy):
    out = []
    for pkg in PKGS:
        ni = _index(pkg, tmp_path / pkg.name / "docs", compaction)
        if policy:
            ni.merge_policy = pkg.LogMergePolicy(**policy)
        out.append(ni)
    return out


@pytest.fixture()
def hybrid_engine(monkeypatch):
    """Segments of any size take the port's hybrid engine."""
    monkeypatch.setattr(PORT.named_index_module, "SMALL_SEGMENT_MAX_DOCS", 0)


@pytest.mark.parametrize("compaction", ["off", "sync", "background"])
def test_seeded_write_sequence_matches_reference(tmp_path, compaction,
                                                 hybrid_engine):
    """One seeded sequence of upserts (within-batch duplicate ids,
    overwrites), deletes, tiered and forced compaction, and a spill and
    restore, applied to both packages; identical state and hits after
    every step."""
    routes = seeded_write_sequence(tmp_path, compaction)
    # the port answered through its hybrid engine (plain versions here)
    assert routes["phase_a"] > 0 and not routes.get("small_segment")


def test_seeded_write_sequence_small_segment_engine(tmp_path):
    """The same sequence with the size constant at its default: every
    segment is small, and the small-segment engine answers."""
    routes = seeded_write_sequence(tmp_path, "off")
    assert routes["small_segment"] > 0
    assert not routes.get("phase_a") and not routes.get("block_scorer")


def seeded_write_sequence(tmp_path, compaction):
    """Run the sequence on both packages, comparing state and hits after
    every step; the port's route counts."""
    rng = np.random.default_rng(17)
    port, ref = open_pair(tmp_path, compaction, min_num_segments=3)
    plans = None

    def step():
        nonlocal plans
        for ni in (port, ref):
            if compaction == "background":
                assert ni.wait_compaction(timeout=120)
        assert_same_index(port, ref)
        if plans is None:
            plans = query_plans(port.segments[0])
        assert_same_hits(port, ref, plans)

    def upsert(ids, dup=()):
        specs = record_specs(rng, ids)
        specs += [(f"d{i}", f"t00003 t00004 rewrite {i}", "/source/1")
                  for i in dup]
        for ni, pkg in ((port, PORT), (ref, REF)):
            ni.upsert(records(pkg, specs))
        step()

    def delete(n):
        live = sorted({d["id"] for s in port.segments
                       for k, d in enumerate(s.stored)
                       if not s.tombstones[k]})
        for did in rng.choice(live, size=n, replace=False):
            port.delete_document(str(did))
            ref.delete_document(str(did))
        step()

    upsert(range(160), dup=(5, 17, 5))
    upsert(range(100, 260))
    delete(12)
    upsert(range(240, 400))
    if compaction == "off":
        before = device_merge.launches
        assert port.run_compaction_pass() and ref.run_compaction_pass()
        # the sources' packs were resident after the searches: the
        # merged pack was rebuilt by the device merge, not uploaded
        assert device_merge.launches == before + 1
        merged = port.segments[0]
        attached = merged._device_pack
        assert attached is not None
        merged._device_pack = None
        fresh = merged.device_pack(torch.device("cpu"))
        for name in ("e_doc", "e_tffid", "tomb"):
            assert torch.equal(getattr(attached, name), getattr(fresh, name))
        step()
    assert port.compaction_stats == ref.compaction_stats
    upsert(range(380, 540))
    delete(7)
    assert port.maybe_merge(force=True) and ref.maybe_merge(force=True)
    step()
    assert len(port.segments) == 1
    upsert(range(0, 40))
    remote = tmp_path / "remote"
    port.spill(PORT.spill.SegmentSpiller(f"file://{remote}/port"))
    ref.spill(REF.spill.SegmentSpiller(f"file://{remote}/ref"))
    assert port.has_cold and not port.segments
    assert port.num_docs == ref.num_docs > 0
    # a write and a delete while cold, applied at restore
    upsert(range(30, 50))
    port.delete_document("d400")
    ref.delete_document("d400")
    assert port.restore() == ref.restore() == 2
    step()
    assert port.compaction_stats == ref.compaction_stats
    for ni in (port, ref):
        ni.close()
    return port.routes


def test_namespace_directories_are_interchangeable(tmp_path):
    """A directory written by one package opens in the other: the same
    segments, tombstones and hits."""
    rng = np.random.default_rng(23)
    port, ref = open_pair(tmp_path, "off")
    for ids in (range(170), range(150, 320)):
        specs = record_specs(rng, ids)
        port.upsert(records(PORT, specs))
        ref.upsert(records(REF, specs))
    for did in ("d3", "d151", "d300"):
        port.delete_document(did)
        ref.delete_document(did)
    port.close()
    ref.close()
    ref_opens_port = _index(REF, tmp_path / "port" / "docs", "off")
    port_opens_ref = _index(PORT, tmp_path / "ref" / "docs", "off")
    assert [s.segment_id for s in port_opens_ref.segments] == [
        s.segment_id for s in ref.segments]
    assert_same_index(port_opens_ref, ref_opens_port)
    assert_same_hits(port_opens_ref, ref_opens_port,
                     query_plans(port_opens_ref.segments[0]))
    # and the port keeps writing to the reference's directory
    more = record_specs(rng, range(300, 330))
    port_opens_ref.upsert(records(PORT, more))
    ref_opens_port.upsert(records(REF, more))
    assert_same_index(port_opens_ref, ref_opens_port)


def _three_resident_segments(tmp_path):
    rng = np.random.default_rng(29)
    ni = PORT.NamedIndex("e", tmp_path / "e", IndexType.DOCS,
                                     device="cpu", compaction="off")
    ni.merge_policy = PORT.LogMergePolicy(min_num_segments=3)
    for b in range(3):
        ni.upsert(records(PORT, record_specs(rng, range(b * 160,
                                                        (b + 1) * 160))))
    for s in ni.segments:
        s.device_pack(torch.device("cpu"))
    return ni


def test_device_merge_error_propagates(tmp_path, monkeypatch):
    """An error in the device merge raises out of the compaction pass;
    the sources stay live and no merged segment is swapped in to upload
    its pack from the host."""
    ni = _three_resident_segments(tmp_path)
    before = list(ni.segments)

    def broken(*a, **k):
        raise RuntimeError("device merge failed")

    monkeypatch.setattr(device_merge, "device_merge_entries", broken)
    with pytest.raises(RuntimeError, match="device merge failed"):
        ni.run_compaction_pass()
    assert ni.segments == before
    assert ni.compaction_stats["merges"] == 0
    assert len(list(ni.path.glob("seg-*.npz"))) == 3


def test_device_merge_rule_reads_no_environment(tmp_path, monkeypatch):
    """The device merge runs exactly when every source pack is resident
    on the index's device; FUGU_DEVICE_MERGE is not read."""
    monkeypatch.setenv("FUGU_DEVICE_MERGE", "off")
    ni = _three_resident_segments(tmp_path)
    before = device_merge.launches
    assert ni.run_compaction_pass()
    assert device_merge.launches == before + 1
    assert ni.segments[0]._device_pack is not None
    # one source without a resident pack: the merged pack waits for
    # the first query's upload
    monkeypatch.setenv("FUGU_DEVICE_MERGE", "on")
    ni2 = _three_resident_segments(tmp_path / "two")
    ni2.segments[1]._device_pack = None
    assert ni2.run_compaction_pass()
    assert device_merge.launches == before + 1
    assert ni2.segments[0]._device_pack is None


def test_host_only_index_touches_no_tensor(tmp_path, monkeypatch):
    """use_device=False is the reference's host configuration: no
    device is resolved and no pack is built, even for a device name
    that does not exist here."""
    ni = PORT.NamedIndex("h", tmp_path / "h", IndexType.DOCS,
                                     use_device=False, compaction="sync",
                                     device="cuda:7")
    assert ni.device is None
    ni.merge_policy = PORT.LogMergePolicy(min_num_segments=2)
    rng = np.random.default_rng(31)
    for b in range(2):
        ni.upsert(records(PORT, record_specs(rng, range(b * 160,
                                                        (b + 1) * 160))))
    before = device_merge.launches
    plans = query_plans(ni.segments[0])
    hits = ni.search_topk_batch(plans, 10)
    assert device_merge.launches == before
    assert all(s._device_pack is None for s in ni.segments)
    assert not ni.routes.get("phase_a") and not ni.routes.get("block_scorer")
    assert not ni.routes.get("small_segment")
    for p, h in zip(plans, hits):
        assert hits_key(h) == hits_key(
            oracle.search(ni.segments, p, 10, ni.stats()))


@pytest.mark.parametrize("env", [None, "sync", "bogus"])
def test_compaction_mode_and_its_override(tmp_path, monkeypatch, env):
    """FUGU_COMPACTION wins over the configured mode, as in the
    reference; an unknown mode is refused."""
    if env:
        monkeypatch.setenv("FUGU_COMPACTION", env)
    for pkg in PKGS:
        make = lambda: _index(pkg, tmp_path / pkg.name, "off")  # noqa: E731
        if env == "bogus":
            with pytest.raises(ValueError, match="compaction mode"):
                make()
        else:
            assert make().compaction_mode == (env or "off")


# -- tests/test_compactor.py, on both packages --------------------------------


@dataclasses.dataclass
class FakeSeg:
    doc_count: int
    dead: int = 0

    @property
    def num_live_docs(self):
        return self.doc_count - self.dead

    @property
    def num_tombstoned(self):
        return self.dead


POLICY_CASES = {
    "below_min_segments": ({}, [(100, 0)] * 7, []),
    "tiny_segments_one_level": (
        {}, [(n, 0) for n in (10, 50, 9000, 200, 3, 800, 40, 77)],
        [list(range(8))]),
    "levels_split_by_log_size": (
        {"min_layer_size": 1, "min_num_segments": 3},
        [(n, 0) for n in (100_000, 110_000, 90_000, 100, 120, 95)],
        [[0, 1, 2], [3, 4, 5]]),
    "mid_size_not_grouped_with_big": (
        {"min_layer_size": 1, "min_num_segments": 2},
        [(100_000, 0), (1000, 0), (1100, 0)], [[1, 2]]),
    "max_docs_excluded": (
        {"min_num_segments": 2},
        [(20_000_000, 0), (21_000_000, 0), (10, 0)], []),
    "oversize_eligible_as_docs_die": (
        {"min_num_segments": 2, "min_layer_size": 1},
        [(20_000_000, 19_600_000), (500_000, 0)], [[0, 1]]),
    "fully_deleted_triggers_small_level": (
        {"min_num_segments": 8}, [(100, 0), (100, 100)], [[0, 1]]),
    "single_dirty_segment_alone": (
        {"min_num_segments": 8, "min_layer_size": 1},
        [(100_000, 0), (10, 10)], []),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_log_merge_policy(case):
    kw, sizes, want = POLICY_CASES[case]
    segs = [FakeSeg(n, d) for n, d in sizes]
    got = [sorted(c) for c in PORT.LogMergePolicy(**kw).select(segs)]
    assert sorted(got) == want
    assert got == [sorted(c) for c in REF.LogMergePolicy(**kw).select(segs)]


def rec(pkg, i, text, ns="cp"):
    return pkg.ObjectRecord(id=f"r{i}", text=text, namespace=ns)


def both(fn):
    """``fn(pkg)`` on the port and on the reference; equal results."""
    got, want = fn(PORT), fn(REF)
    assert got == want
    return got


def _ids(results):
    return sorted(r.id for r in results)


def test_background_merge_converges(tmp_path):
    def run(pkg):
        ds = pkg.Dataset("bg", tmp_path / pkg.name, **pkg.kw)
        try:
            for i in range(20):
                ds.ingest([rec(pkg, i, f"bg doc number {i}", ns="bg")])
            assert ds.wait_compaction(timeout=60)
            assert len(ds.docs().segments) <= 8
            assert ds.docs().compaction_stats["merges"] >= 1
            res = ds.search("bg doc", [], 0, 25)
            assert len(res) == 20
            ds2 = pkg.Dataset("bg", tmp_path / pkg.name, **pkg.kw)
            assert ds2.stats().docs_count == 20
            return _ids(res), _ids(ds2.search("bg doc", [], 0, 25))
        finally:
            ds.close()

    both(run)


def test_commit_does_not_merge_inline(tmp_path):
    def run(pkg):
        idx = _index(pkg, tmp_path / pkg.name, "background")
        try:
            calls = []
            orig = idx.run_compaction_pass

            def tracked():
                calls.append(threading.current_thread().name)
                return orig()

            idx.run_compaction_pass = tracked
            idx._compactor.close()
            idx._compactor = pkg.BackgroundCompactor(tracked)
            for i in range(10):
                idx.upsert([rec(pkg, i, f"inline test {i}")])
            assert idx.wait_compaction(timeout=60)
            assert calls, "compactor never ran"
            return sorted(set(calls))
        finally:
            idx.close()

    assert both(run) == ["fugu-compactor"]


def test_delete_during_merge_is_forwarded(tmp_path):
    def run(pkg):
        idx = _index(pkg, tmp_path / pkg.name, "off")
        for i in range(6):
            idx.upsert([rec(pkg, i, f"race doc {i}")])
        srcs = list(idx.segments)
        snaps = [s.tombstones.copy() for s in srcs]
        merged, plan = pkg.merge_segments(
            srcs, idx.schema, tombstones=snaps, return_plan=True)
        idx.delete_document("r2")  # lands after the merge's snapshot
        assert idx._swap_merged(srcs, merged, plan)
        seg = idx.segments[0]
        assert len(idx.segments) == 1
        assert seg.doc_count == 6 and seg.num_tombstoned == 1
        q = pkg.parse("race", default_fields=("text",),
                      known_fields=("text",))
        ids = {seg.stored[h.doc]["id"] for h in idx.search_topk(q, 10)}
        idx2 = _index(pkg, tmp_path / pkg.name, "off")
        return sorted(ids), idx2.segments[0].num_tombstoned

    assert both(run) == (["r0", "r1", "r3", "r4", "r5"], 1)


def test_stale_merge_discarded_after_force_merge(tmp_path):
    def run(pkg):
        idx = _index(pkg, tmp_path / pkg.name, "off")
        for i in range(4):
            idx.upsert([rec(pkg, i, f"stale doc {i}")])
        srcs = list(idx.segments)
        snaps = [s.tombstones.copy() for s in srcs]
        merged, plan = pkg.merge_segments(
            srcs, idx.schema, tombstones=snaps, return_plan=True)
        assert idx.maybe_merge(force=True)
        live_ids = [s.segment_id for s in idx.segments]
        assert idx._swap_merged(srcs, merged, plan)
        assert [s.segment_id for s in idx.segments] == live_ids
        leftovers = {p.name[len("seg-"):-len(".npz")]
                     for p in (tmp_path / pkg.name).glob("seg-*.npz")}
        assert leftovers == set(live_ids)
        return len(idx.segments), idx.segments[0].doc_count

    assert both(run) == (1, 4)


def test_write_amplification_bounded(tmp_path):
    def run(pkg):
        idx = _index(pkg, tmp_path / pkg.name, "sync")
        idx.merge_policy = pkg.LogMergePolicy(min_layer_size=64)
        for b in range(64):
            idx.upsert([rec(pkg, b * 16 + j, f"amp doc {b} {j}")
                        for j in range(16)])
        st = idx.compaction_stats
        assert st["docs_ingested"] == 64 * 16
        assert st["docs_written"] / st["docs_ingested"] < 2.5
        assert len(idx.segments) <= 16
        return dict(st), [s.doc_count for s in idx.segments]

    both(run)


def test_compaction_attaches_device_merged_pack(tmp_path):
    """With every source pack resident, the merged segment comes out of
    compaction with its pack on the device, identical to a fresh upload
    (the reference forces this with FUGU_DEVICE_MERGE=on)."""
    idx = _index(PORT, tmp_path / "d", "off")
    for i in range(9):
        idx.upsert([rec(PORT, i * 4 + j, f"devmerge doc {i} {j}")
                    for j in range(4)])
    cpu = torch.device("cpu")
    for s in idx.segments:
        s.device_pack(cpu)
    assert idx.run_compaction_pass()
    assert len(idx.segments) <= 8
    merged = max(idx.segments, key=lambda s: s.doc_count)
    attached = merged._device_pack
    assert attached is not None
    merged._device_pack = None
    fresh = merged.device_pack(cpu)
    for name in ("e_doc", "e_tffid", "tomb"):
        assert torch.equal(getattr(attached, name), getattr(fresh, name))


def test_sync_mode_deterministic(tmp_path):
    def run(pkg):
        idx = _index(pkg, tmp_path / pkg.name, "sync")
        for i in range(10):
            idx.upsert([rec(pkg, i, f"sync doc {i}")])
        assert idx.merge_policy.select(idx.segments) == []
        return [s.doc_count for s in idx.segments]

    assert len(both(run)) <= 8


def test_wait_idle_false_after_failed_pass():
    state = {"fail": True, "calls": 0}

    def run_pass():
        state["calls"] += 1
        if state["fail"]:
            state["fail"] = False
            raise RuntimeError("transient merge failure")
        return False

    c = PORT.BackgroundCompactor(run_pass)
    c.notify()
    assert c.wait_idle(timeout=10) is False
    c.notify()
    assert c.wait_idle(timeout=10) is True
    assert state["calls"] == 2
    c.close()


def test_merge_gc_spares_unpublished_packs(tmp_path):
    def run(pkg):
        root = tmp_path / pkg.name
        ds = pkg.Dataset("gcr", root, **pkg.kw)
        for b in range(3):
            ds.ingest([pkg.ObjectRecord(id=f"g{b}-{i}", text=f"gc doc {b} {i}",
                                        namespace="gcr") for i in range(4)])
        idx = ds.docs()
        src = next(idx.path.glob("seg-*.npz"))
        phantom = idx.path / "seg-deadbeefcafe0123.npz"
        shutil.copy(src, phantom)
        assert idx.maybe_merge(force=True)
        assert phantom.exists()
        hits = _ids(ds.search("gc doc", [], 0, 20))
        ds.close()
        ds2 = pkg.Dataset("gcr", root, **pkg.kw)
        assert not phantom.exists()
        out = hits, _ids(ds2.search("gc doc", [], 0, 20))
        ds2.close()
        return out

    assert len(both(run)[0]) == 12


# -- tests/test_storage.py's filesystem cases, on both packages --------------


def _ds(pkg, root, ns):
    return pkg.Dataset(ns, root / pkg.name, **pkg.kw)


def test_segment_spill_restore(tmp_path):
    def run(pkg):
        ds = _ds(pkg, tmp_path / "data", "cold")
        remote = tmp_path / "remote" / pkg.name
        ds.ingest([pkg.ObjectRecord(id=f"c{i}", text=f"cold storage doc {i}",
                                    namespace="cold") for i in range(5)])
        assert ds.search("cold storage", [], 0, 10)
        ds.spill(str(remote))
        docs_dir = tmp_path / "data" / pkg.name / "cold" / "docs"
        assert not list(docs_dir.glob("seg-*.npz"))
        assert list(docs_dir.glob("seg-*.spilled"))
        assert ds.stats().docs_count == 5 and ds.has_cold_segments
        ds.restore(str(remote))
        return ds.stats().docs_count, [
            (r.id, r.score) for r in ds.search("cold storage", [], 0, 10)]

    assert len(both(run)[1]) == 5


def test_segment_spill_restore_over_s3(tmp_path, monkeypatch):
    """The cold tier's S3 transport, with the reference's fake client."""
    def run(pkg):
        client = _FakeS3Client()
        monkeypatch.setattr(pkg.spill, "make_s3_client", lambda: client)
        ds = _ds(pkg, tmp_path / "data", "cold")
        ds.ingest([pkg.ObjectRecord(id=f"s{i}", text=f"remote tier doc {i}",
                                    namespace="cold") for i in range(3)])
        ds.spill("s3://bucket/spill/cold")
        assert any(k[1].startswith("spill/cold/") for k in client.objects)
        ds.restore("s3://bucket/spill/cold")
        return ds.stats().docs_count, [
            (r.id, r.score) for r in ds.search("remote tier", [], 0, 10)]

    assert len(both(run)[1]) == 3


def test_spilled_namespace_reopens_after_restart(tmp_path):
    def run(pkg):
        remote = tmp_path / "remote" / pkg.name
        ds = _ds(pkg, tmp_path / "data", "ns")
        ds.ingest([pkg.ObjectRecord(id="a", text="alpha beta", namespace="ns")])
        ds.spill(str(remote))
        ds2 = _ds(pkg, tmp_path / "data", "ns")
        ds2.restore(str(remote))
        return [r.id for r in ds2.search("alpha", [], 0, 10)]

    assert both(run) == ["a"]


def test_write_to_spilled_index_preserves_cold_segments(tmp_path):
    def run(pkg):
        remote = tmp_path / "remote" / pkg.name
        ds = _ds(pkg, tmp_path / "data", "ns")
        ds.ingest([pkg.ObjectRecord(id="old", text="archived alpha",
                                    namespace="ns")])
        ds.spill(str(remote))
        ds2 = _ds(pkg, tmp_path / "data", "ns")
        ds2.ingest([pkg.ObjectRecord(id="new", text="fresh beta",
                                     namespace="ns")])
        assert set(ds2.docs().cold_segments) <= set(
            ds2.docs().manifest.segment_ids)
        assert len(ds2.docs().cold_segments) == 1
        ds2.restore(str(remote))
        return sorted(r.id for r in ds2.search("alpha beta archived fresh",
                                               [], 0, 10))

    assert both(run) == ["new", "old"]


def test_delete_and_merge_preserve_cold_segments(tmp_path):
    def run(pkg):
        root, remote = tmp_path / "data", tmp_path / "remote" / pkg.name
        ds = _ds(pkg, root, "ns")
        ds.ingest([pkg.ObjectRecord(id="old", text="cold gamma",
                                    namespace="ns")])
        ds.spill(str(remote))
        ds2 = _ds(pkg, root, "ns")
        cold_id = next(iter(ds2.docs().cold_segments))
        ds2.ingest([pkg.ObjectRecord(id="h1", text="hot one", namespace="ns")])
        ds2.ingest([pkg.ObjectRecord(id="h2", text="hot two", namespace="ns")])
        ds2.delete_document("h1")
        ds2.docs().maybe_merge(force=True)
        assert cold_id in ds2.docs().manifest.segment_ids
        assert (root / pkg.name / "ns" / "docs"
                / f"seg-{cold_id}.spilled").exists()
        ds2.restore(str(remote))
        return sorted(r.id for r in ds2.search("cold hot gamma one two",
                                               [], 0, 10))

    assert both(run) == ["h2", "old"]


def test_spill_marker_durable_before_unlink(tmp_path, monkeypatch):
    from pathlib import Path

    sp = PORT.spill.SegmentSpiller(f"file://{tmp_path}/remote")
    d = tmp_path / "idx"
    d.mkdir()
    (d / "seg-abc.npz").write_bytes(b"payload")
    real_unlink = Path.unlink

    def crash(self, *a, **k):
        raise OSError("simulated crash mid-spill")

    monkeypatch.setattr(Path, "unlink", crash)
    with pytest.raises(OSError):
        sp.spill(d, "abc")
    monkeypatch.setattr(Path, "unlink", real_unlink)
    assert (d / "seg-abc.spilled").exists()
    assert (d / "seg-abc.npz").exists()
    sp.restore(d, "abc")
    assert (d / "seg-abc.npz").read_bytes() == b"payload"
    assert not (d / "seg-abc.spilled").exists()


def test_spill_unknown_segment_writes_no_marker(tmp_path):
    sp = PORT.spill.SegmentSpiller(f"file://{tmp_path}/remote")
    d = tmp_path / "idx"
    d.mkdir()
    assert sp.spill(d, "ghost") == []
    assert not (d / "seg-ghost.spilled").exists()
    assert not sp.is_spilled(d, "ghost")


def test_cold_upsert_no_duplicate_after_restore(tmp_path):
    def run(pkg):
        root, remote = tmp_path / "data", tmp_path / "remote" / pkg.name
        ds = _ds(pkg, root, "cw")
        ds.ingest([pkg.ObjectRecord(id="dup", text="version one alpha",
                                    namespace="cw")])
        ds.spill(f"file://{remote}")
        ds.ingest([pkg.ObjectRecord(id="dup", text="version two beta",
                                    namespace="cw")])
        assert ds.docs().has_cold
        ds.restore(f"file://{remote}")
        hits = ds.search("version alpha beta", [], 0, 10)
        out = [(h.id, h.text, h.score) for h in hits], ds.get("dup")
        ds.close()
        return out

    hits, got = both(run)
    assert [h[0] for h in hits] == ["dup"] and "two" in hits[0][1]
    assert got[0]["text"] == "version two beta"


def test_cold_delete_applies_at_restore(tmp_path):
    def run(pkg):
        root, remote = tmp_path / "data", tmp_path / "remote" / pkg.name
        ds = _ds(pkg, root, "cd")
        ds.ingest([
            pkg.ObjectRecord(id="gone", text="ephemeral doc", namespace="cd"),
            pkg.ObjectRecord(id="kept", text="permanent doc", namespace="cd"),
        ])
        ds.spill(f"file://{remote}")
        ds.delete_document("gone")
        ds.close()
        ds2 = _ds(pkg, root, "cd")
        assert ds2.has_cold_segments
        first = sorted(h.id for h in ds2.search("ephemeral permanent doc",
                                                [], 0, 10))
        assert ds2.get("gone") == []
        ds2.ingest([pkg.ObjectRecord(id="gone", text="reborn doc",
                                     namespace="cd")])
        ds2.spill(f"file://{remote}")
        ds2.restore(f"file://{remote}")
        second = sorted(h.id for h in ds2.search("reborn permanent doc",
                                                 [], 0, 10))
        ds2.close()
        return first, second

    assert both(run) == (["kept"], ["gone", "kept"])
