"""Spill-tier surface and policy on the port (tests/test_spill_surface.py).

The policy cases (a query against a namespace with cold segments never
returns partial results: auto-restore on query, or a 409 when it is off
or fails; idle namespaces spill; reads racing a spill retry) run on each
package, the port with ``device="cpu"`` and the reference with
``use_device=False``.  The HTTP cases run on the pair of live servers of
tests/test_torch_server.py, which holds every response of the port's
server to the reference's."""

import time

import pytest
import torch

from test_torch_server import (  # noqa: F401 (the fixture applies here)
    PairServer,
    device_engine_for_small_segments,
)
from test_torch_writer import PKGS

torch.set_num_threads(1)

#: a body's "@ROOT@" is each live server's own directory
COLD_PREFIX = "file://@ROOT@/cold"


@pytest.fixture(params=PKGS, ids=lambda p: p.name)
def pkg(request):
    return request.param


def recs(pkg, n, ns, prefix="sp"):
    return [
        pkg.ObjectRecord(
            id=f"{prefix}{i}", text=f"spill surface doc number {i}", namespace=ns
        )
        for i in range(n)
    ]


def prefix_of(tmp_path):
    return f"file://{tmp_path}/cold"


class TestAutoRestore:
    def test_restart_query_autorestore(self, pkg, tmp_path):
        ds = pkg.Dataset("ar", tmp_path / "data", **pkg.kw)
        ds.ingest(recs(pkg, 12, "ar"))
        before = [(r.id, r.score) for r in ds.search("spill surface", [], 0, 20)]
        assert len(before) == 12
        ds.spill(prefix_of(tmp_path))
        ds.close()

        # restart: segments are cold on disk (markers + manifest only)
        ds2 = pkg.Dataset("ar", tmp_path / "data", **pkg.kw)
        assert ds2.has_cold_segments
        # the query must transparently restore and serve COMPLETE results
        after = [(r.id, r.score) for r in ds2.search("spill surface", [], 0, 20)]
        assert after == before
        # the read path restored the index it touched (the other two
        # restore lazily on their own read paths)
        assert not ds2.docs().has_cold and ds2.docs().is_loaded
        ds2.close()

    def test_autorestore_disabled_raises(self, pkg, tmp_path, monkeypatch):
        ds = pkg.Dataset("cd", tmp_path / "data", **pkg.kw)
        ds.ingest(recs(pkg, 5, "cd"))
        ds.spill(prefix_of(tmp_path))
        ds.close()
        ds2 = pkg.Dataset("cd", tmp_path / "data", **pkg.kw)
        monkeypatch.setenv("FUGU_SPILL_AUTORESTORE", "0")
        with pytest.raises(pkg.dataset.ColdNamespaceError):
            ds2.search("spill", [], 0, 10)
        ds2.close()

    def test_failed_restore_raises_not_partial(self, pkg, tmp_path):
        """If the remote tier is gone, the query errors instead of
        silently serving the warm subset."""
        import shutil

        ds = pkg.Dataset("fr", tmp_path / "data", **pkg.kw)
        ds.ingest(recs(pkg, 5, "fr"))
        ds.spill(prefix_of(tmp_path))
        ds.close()
        shutil.rmtree(tmp_path / "cold")  # remote tier lost
        ds2 = pkg.Dataset("fr", tmp_path / "data", **pkg.kw)
        with pytest.raises(pkg.dataset.ColdNamespaceError):
            ds2.search("spill", [], 0, 10)
        ds2.close()

    def test_get_and_suggest_also_guarded(self, pkg, tmp_path):
        ds = pkg.Dataset("gg", tmp_path / "data", **pkg.kw)
        ds.ingest(recs(pkg, 4, "gg"))
        ds.spill(prefix_of(tmp_path))
        ds.close()
        ds2 = pkg.Dataset("gg", tmp_path / "data", **pkg.kw)
        assert ds2.get("sp1")  # auto-restores
        ds2.close()


class TestIdleSpill:
    def test_manager_spills_idle_namespaces(self, pkg, tmp_path):
        cfg = pkg.config.ServerConfig.with_defaults(str(tmp_path / "data"), "main")
        cfg.spill_prefix = prefix_of(tmp_path)
        cfg.spill_idle_ttl_secs = 0.05
        mgr = pkg.manager.DatasetManager(cfg, **pkg.mgr_kw)
        ds = mgr.get_or_create_dataset("main")
        ds.ingest(recs(pkg, 6, "main"))
        ds.wait_compaction(30)
        time.sleep(0.1)
        spilled = mgr.spill_idle()
        assert spilled == ["main"]
        assert ds.has_cold_segments
        # the next query transparently restores
        out = ds.search("spill surface", [], 0, 10)
        assert len(out) == 6
        # a freshly-touched namespace is not spilled
        assert mgr.spill_idle() == []
        mgr.close()

    def test_idle_spill_skips_without_prefix(self, pkg, tmp_path):
        cfg = pkg.config.ServerConfig.with_defaults(str(tmp_path / "data"), "main")
        cfg.spill_idle_ttl_secs = 0.01
        mgr = pkg.manager.DatasetManager(cfg, **pkg.mgr_kw)
        mgr.get_or_create_dataset("main").ingest(recs(pkg, 2, "main"))
        time.sleep(0.05)
        assert mgr.spill_idle() == []
        mgr.close()


@pytest.fixture
def server(tmp_path):
    s = PairServer(tmp_path)
    yield s
    s.stop()


class TestHttpSurface:
    def test_spill_restore_roundtrip(self, server, tmp_path):
        server.post_json(
            "/ingest", {"data": [{"id": f"h{i}", "text": f"cold http doc {i}"} for i in range(6)]}
        )
        prefix = COLD_PREFIX
        status, out = server.post_json(
            "/namespaces/default/spill", {"prefix": prefix}
        )
        assert status == 200 and out["status"] == "success"
        assert out["spilled_segments"]["docs"] >= 1
        ds = server.db.get_dataset("default")
        assert ds.has_cold_segments
        status, out = server.post_json("/namespaces/default/restore", {})
        assert status == 200 and out["restored_segments"]["docs"] >= 1
        assert not ds.has_cold_segments
        _, res = server.get_json("/search?q=cold+http")
        assert res["total"] == 6

    def test_spill_unknown_namespace_404(self, server, tmp_path):
        status, _ = server.post_json(
            "/namespaces/nope/spill", {"prefix": COLD_PREFIX}
        )
        assert status == 404

    def test_spill_without_prefix_400(self, server):
        server.post_json(
            "/ingest", {"data": [{"id": "x1", "text": "no prefix doc"}]}
        )
        status, out = server.post_json("/namespaces/default/spill", {})
        assert status == 400
        assert "prefix" in out["error"]

    def test_query_on_spilled_namespace_autorestores(self, server, tmp_path):
        server.post_json(
            "/ingest",
            {"data": [{"id": f"q{i}", "text": f"query cold doc {i}"} for i in range(5)]},
        )
        server.post_json(
            "/namespaces/default/spill", {"prefix": COLD_PREFIX}
        )
        assert server.db.get_dataset("default").has_cold_segments
        status, res = server.get_json("/search?q=query+cold")
        assert status == 200 and res["total"] == 5

    def test_query_on_cold_namespace_409_when_autorestore_off(
        self, server, tmp_path, monkeypatch
    ):
        monkeypatch.setenv("FUGU_SPILL_AUTORESTORE", "0")
        server.post_json(
            "/ingest", {"data": [{"id": "z1", "text": "frozen doc"}]}
        )
        server.post_json(
            "/namespaces/default/spill", {"prefix": COLD_PREFIX}
        )
        status, out = server.get_json("/search?q=frozen")
        assert status == 409
        assert "cold" in out["error"]


class TestSpillRaceWithReads:
    def test_sweeper_spill_between_guard_and_snapshot(self, pkg, tmp_path):
        """The idle sweeper winning the race AFTER the cold guard passes
        must not let the query serve an empty snapshot: spill() records
        cold_segments before clearing the list (under the index lock),
        so Dataset._read_snapshot observes has_cold on its post-snapshot
        recheck and retries through restore."""
        ds = pkg.Dataset("rc", tmp_path / "data", **pkg.kw)
        ds.ingest(recs(pkg, 8, "rc"))
        idx = ds.docs()
        real = idx.searcher_segments
        fired = {}

        def racing_snapshot():
            if not fired:  # sweeper spills right after _ensure_loaded
                fired["x"] = True
                ds.spill(prefix_of(tmp_path))
            return real()

        idx.searcher_segments = racing_snapshot
        out = ds.search("spill surface", [], 0, 20)
        assert len(out) == 8, "race served a partial/empty snapshot"
        ds.close()

    def test_spill_restore_pair_inside_walk_retries(self, pkg, tmp_path):
        """A spill+restore pair completing ENTIRELY inside a guarded
        walk leaves has_cold False again by recheck time — only the
        spill_gen bump reveals that the walk may have started on the
        post-spill empty list and must be retried."""
        ds = pkg.Dataset("sg", tmp_path / "data", **pkg.kw)
        ds.ingest(recs(pkg, 8, "sg"))
        idx = ds.docs()
        fired = {}

        def walk():
            if not fired:
                fired["x"] = True
                ds.spill(prefix_of(tmp_path))
                idx.restore()
                return []  # what a walk over the post-spill list yields
            return ["complete"]

        assert ds._guarded_read(idx, walk) == ["complete"]
        ds.close()

    def test_num_docs_stable_during_spill(self, pkg, tmp_path, monkeypatch):
        """Lockless stats readers must never see a segment counted both
        warm and cold while spill()'s slow per-segment remote writes are
        in flight (cold entries publish with the list swap + num_docs
        dedups by id)."""
        monkeypatch.setenv("FUGU_COMPACTION", "off")
        ds = pkg.Dataset("nd", tmp_path / "data", **pkg.kw)
        for b in range(3):  # three batches -> three segments
            ds.ingest(recs(pkg, 4, "nd", prefix=f"b{b}-"))
        idx = ds.docs()
        assert idx.num_docs == 12 and len(idx.segments) == 3
        seen = []

        class FakeSpiller:
            def spill(self, path, seg_id):
                seen.append(idx.num_docs)  # mid-loop stats read

        idx.spill(FakeSpiller())
        assert seen == [12, 12, 12], f"mid-spill counts drifted: {seen}"
        assert idx.num_docs == 12  # all-cold, counts preserved
        ds.close()


class TestFacetReadsGuarded:
    def test_facet_reads_autorestore(self, pkg, tmp_path):
        """Facet reads walk idx.segments directly; on a cold namespace
        they must restore-first, not silently serve empty trees."""
        ds = pkg.Dataset("fc", tmp_path / "data", **pkg.kw)
        ds.ingest(
            [
                pkg.ObjectRecord(
                    id=f"f{i}",
                    text=f"facet doc {i}",
                    namespace="fc",
                    facets=[f"/color/{'red' if i % 2 else 'blue'}"],
                )
                for i in range(6)
            ]
        )
        want_tree = ds.get_facet_tree(None).to_dict()
        want_facets = ds.get_facets(None)
        ds.spill(prefix_of(tmp_path))
        ds.close()

        ds2 = pkg.Dataset("fc", tmp_path / "data", **pkg.kw)
        assert ds2.has_cold_segments
        assert ds2.get_facet_tree(None).to_dict() == want_tree
        ds2.close()

        ds3 = pkg.Dataset("fc", tmp_path / "data", **pkg.kw)
        ds3.spill(prefix_of(tmp_path))
        assert ds3.get_facets(None) == want_facets
        assert ds3.search_facet("/color", None)  # filter_index guarded too
        ds3.close()

    def test_facet_reads_409_when_autorestore_off(self, pkg, tmp_path, monkeypatch):
        ds = pkg.Dataset("f9", tmp_path / "data", **pkg.kw)
        ds.ingest(recs(pkg, 3, "f9"))
        ds.spill(prefix_of(tmp_path))
        monkeypatch.setenv("FUGU_SPILL_AUTORESTORE", "0")
        with pytest.raises(pkg.dataset.ColdNamespaceError):
            ds.get_facet_tree(None)
        with pytest.raises(pkg.dataset.ColdNamespaceError):
            ds.get_filter_values_at_path("/namespace/f9")
        ds.close()

    def test_cold_namespace_stats_not_zero(self, pkg, tmp_path):
        """Spilling must not make stats/health report the namespace as
        empty — cold entries carry their live-doc counts (and survive a
        restart via the manifest commit at spill time)."""
        ds = pkg.Dataset("st", tmp_path / "data", **pkg.kw)
        ds.ingest(recs(pkg, 7, "st"))
        ds.delete_document("sp0")
        ds.wait_compaction(30)
        live = ds.stats().docs_count
        assert live == 6
        ds.spill(prefix_of(tmp_path))
        assert ds.stats().docs_count == live
        ds.close()
        ds2 = pkg.Dataset("st", tmp_path / "data", **pkg.kw)
        assert ds2.has_cold_segments
        assert ds2.stats().docs_count == live
        ds2.close()


class TestPendingDeleteScoping:
    def test_respill_does_not_kill_newest_copy(self, pkg, tmp_path):
        """Upsert against a cold namespace queues a pending delete for
        the COLD copies; if the warm segment holding the NEW copy is
        spilled later, restore must not tombstone it too (that silently
        lost the latest write)."""
        ds = pkg.Dataset("pds", tmp_path / "data", **pkg.kw)
        ds.ingest(recs(pkg, 6, "pds"))
        ds.spill(prefix_of(tmp_path))
        assert ds.has_cold_segments
        # lazy write to the cold namespace: new copy of sp0 in a warm
        # segment, pending delete queued against the cold segments
        ds.ingest(
            [pkg.ObjectRecord(id="sp0", text="the freshest copy", namespace="pds")]
        )
        # spill AGAIN: the warm segment with the fresh copy goes cold too
        ds.spill(prefix_of(tmp_path))
        # restore applies pending deletes — scoped to queue-time targets
        ds.restore()
        hits = ds.get("sp0")
        assert hits, "newest copy was tombstoned at restore"
        assert len(hits) == 1, "stale cold copy resurrected as duplicate"
        assert "freshest" in hits[0]["text"]
        matches = [r for r in ds.search("freshest", [], 0, 10)]
        assert [r.id for r in matches] == ["sp0"]
        ds.close()
