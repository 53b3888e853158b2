"""The port's Dataset and DatasetManager against the reference's.

The cases of tests/test_engine.py run on the port (``device="cpu"``) and
on the reference (``use_device=False``) over the same records; each keeps
the reference test's assertions, and the two packages must return the
same results (ids, score floats, order, facets, stats).  Also: the churn
of tests/test_mutation_fuzz.py at a small size, and a sharded config,
which serves through the manager's mesh."""

import dataclasses
import enum
import json

import msgpack
import numpy as np
import pytest
import torch

import fugu_tpu_torch.config as port_config
import fugu_tpu_torch.engine.manager as port_manager
from test_torch_writer import PORT, REF

torch.set_num_threads(1)


def norm(x):
    """Plain data of a result, whatever package's classes hold it."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, enum.Enum):
        return x.value
    return x


def rec(pkg, i, text, ns="testns", **kw):
    return pkg.ObjectRecord(id=f"doc{i}", text=text, namespace=ns, **kw)


def seed(pkg, ds):
    ds.ingest([
        rec(pkg, 1, "the quick brown fox", data_type="animal"),
        rec(pkg, 2, "lazy dogs sleep all day", data_type="animal"),
        rec(pkg, 3, "quick quick silver fox", data_type="metal"),
        rec(pkg, 4, "a story about nothing", organization="acme"),
    ])


def seeded(pkg, tmp):
    ds = pkg.Dataset("testns", tmp, **pkg.kw)
    seed(pkg, ds)
    return ds


def ids(results):
    return [r.id for r in results]


# -- the cases of tests/test_engine.py: fn(pkg, tmp) -> comparable result ----


def c_ingest_and_stats(pkg, tmp):
    st = seeded(pkg, tmp).stats()
    assert st.docs_count == 4 and st.namespace == "testns"
    assert st.filter_count > 0 and st.query_count > 0
    assert st.total_docs() == st.docs_count + st.filter_count + st.query_count
    return st


def c_search_ranking(pkg, tmp):
    res = seeded(pkg, tmp).search("quick fox", [], 0, 20)
    assert sorted(ids(res)[:2]) == ["doc1", "doc3"]
    assert all(r.score > 0 for r in res) and res[0].text
    return res


def c_upsert_overwrites(pkg, tmp):
    ds = seeded(pkg, tmp)
    ds.upsert([rec(pkg, 1, "completely different content")])
    assert ds.stats().docs_count == 4
    res = ds.search("brown fox", [], 0, 20)
    assert "doc1" not in ids(res)
    res2 = ds.search("different content", [], 0, 20)
    assert ids(res2) == ["doc1"]
    return res, res2


def c_duplicate_ids_in_one_batch(pkg, tmp):
    ds = pkg.Dataset("testns", tmp, **pkg.kw)
    ds.ingest([rec(pkg, 9, "first version"), rec(pkg, 9, "second version")])
    assert ds.stats().docs_count == 1
    res = ds.search("version", [], 0, 20)
    assert len(res) == 1 and res[0].text == "second version"
    return res


def c_delete_document(pkg, tmp):
    ds = seeded(pkg, tmp)
    ds.delete_document("doc2")
    assert ds.stats().docs_count == 3
    assert ds.search("lazy dogs", [], 0, 20) == []
    return ds.search("quick", [], 0, 20)


def c_empty_query_matches_all(pkg, tmp):
    res = seeded(pkg, tmp).search("", [], 0, 20)
    assert len(res) == 4 and all(r.score == 1.0 for r in res)
    return res


def c_facet_filter(pkg, tmp):
    res = seeded(pkg, tmp).search("quick", ["/namespace/testns/data/animal"],
                                  0, 20)
    assert ids(res) == ["doc1"]
    return res


def c_facet_filter_ancestor_matches(pkg, tmp):
    res = seeded(pkg, tmp).search("", ["/namespace/testns/data"], 0, 20)
    assert sorted(ids(res)) == ["doc1", "doc2", "doc3"]
    return res


def c_wildcard_filter(pkg, tmp):
    res = seeded(pkg, tmp).search("", ["*acme*"], 0, 20)
    assert ids(res) == ["doc4"]
    return res


def c_pagination(pkg, tmp):
    ds = seeded(pkg, tmp)
    page0, page1 = ds.search("", [], 0, 2), ds.search("", [], 1, 2)
    assert len(page0) == 2 and len(page1) == 2
    assert set(ids(page0)) | set(ids(page1)) == {"doc1", "doc2", "doc3",
                                                 "doc4"}
    return page0, page1


def c_get_by_id(pkg, tmp):
    ds = seeded(pkg, tmp)
    docs = ds.get("doc3")
    assert len(docs) == 1 and docs[0]["id"] == "doc3"
    assert ds.get("missing") == []
    return docs


def c_parse_filters_operators(pkg, tmp):
    fs = pkg.dataset.parse_filters(["/a/b", "a/c", "/p/*", "/k=v", "*pat*"])
    op = pkg.dataset.FilterOperator
    assert fs[0].operator is op.EQUALS and fs[0].path == "/a/b"
    assert fs[1].path == "/a/c"
    assert fs[2].operator is op.PREFIX and fs[2].path == "/p"
    assert fs[3].operator is op.EQUALS and fs[3].value == "v"
    assert fs[4].operator is op.WILDCARD and fs[4].path == "pat"
    return fs


def c_namespace_facet_apis(pkg, tmp):
    ds = seeded(pkg, tmp)
    assert ds.get_available_namespaces() == ["testns"]
    facets = ds.get_namespace_facets("testns")
    paths = [p for p, _ in facets]
    assert "/namespace/testns/data" in paths
    assert "/namespace/testns/organization" in paths
    return facets


def c_facet_tree(pkg, tmp):
    tree = seeded(pkg, tmp).get_facet_tree(None)
    data = tree.tree["namespace"].children["testns"].children["data"]
    assert set(data.children) == {"animal", "metal"}
    assert data.children["animal"].count == 2 and tree.max_depth == 4
    return tree


def c_facet_tree_max_depth(pkg, tmp):
    tree = seeded(pkg, tmp).get_facet_tree(2)
    assert tree.tree["namespace"].children == {}
    assert tree.total_facets >= 2
    return tree


def c_filter_values_at_path(pkg, tmp):
    vals = seeded(pkg, tmp).get_filter_values_at_path("/namespace/testns/data")
    assert vals == ["animal", "metal"]
    return vals


def c_all_filter_paths(pkg, tmp):
    paths = seeded(pkg, tmp).get_all_filter_paths()
    assert sorted(paths["/namespace/testns/data"]) == ["animal", "metal"]
    return paths


def c_filter_paths_for_namespace(pkg, tmp):
    ds = pkg.Dataset("ns2", tmp, **pkg.kw)
    ds.ingest([pkg.ObjectRecord(
        id="x1", text="hello",
        facets=["/namespace/ns2", "/topic/science/physics"])])
    paths = ds.get_filter_paths_for_namespace("ns2")
    assert paths == {"/topic/science": ["physics"]}
    return paths


def c_search_facet(pkg, tmp):
    ds = seeded(pkg, tmp)
    hits = ds.search_facet("/namespace/testns/data", None)
    assert [p for p, _ in hits] == ["/namespace/testns/data/animal",
                                    "/namespace/testns/data/metal"]
    hits2 = ds.search_facet("/namespace/testns/data", "METAL")
    assert [p for p, _ in hits2] == ["/namespace/testns/data/metal"]
    return hits, hits2


def c_suggest(pkg, tmp):
    ds = seeded(pkg, tmp)
    out, out2 = ds.suggest("lazy"), ds.suggest("laz")
    assert any("lazy" in s for s in out) and any("lazy" in s for s in out2)
    return out, out2


def c_persistence_reload(pkg, tmp):
    ds = pkg.Dataset("persist", tmp, **pkg.kw)
    ds.ingest([rec(pkg, 1, "persistent data here", ns="persist")])
    ds.delete_document("nonexistent")
    ds2 = pkg.Dataset("persist", tmp, **pkg.kw)
    assert ds2.stats().docs_count == 1
    res = ds2.search("persistent", [], 0, 10)
    assert ids(res) == ["doc1"]
    return res


def c_persistence_tombstones_survive(pkg, tmp):
    ds = pkg.Dataset("pt", tmp, **pkg.kw)
    ds.ingest([pkg.ObjectRecord(id=f"d{i}", text=f"common word{i}",
                                namespace="pt") for i in range(3)])
    ds.delete_document("d1")
    ds2 = pkg.Dataset("pt", tmp, **pkg.kw)
    assert ds2.stats().docs_count == 2
    res = ds2.search("common", [], 0, 10)
    assert "d1" not in ids(res)
    return res


def c_merge_policy_compacts(pkg, tmp):
    ds = pkg.Dataset("mg", tmp, **pkg.kw)
    for i in range(10):
        ds.ingest([pkg.ObjectRecord(id=f"m{i}", text=f"merge test doc {i}",
                                    namespace="mg")])
    ds.wait_compaction(timeout=60)
    assert len(ds.docs().segments) <= 9
    res = ds.search("merge test", [], 0, 20)
    assert len(res) == 10
    ds.close()
    return sorted(ids(res))


def c_merge_purges_tombstones(pkg, tmp):
    ds = pkg.Dataset("mp", tmp, **pkg.kw)
    ds.ingest([pkg.ObjectRecord(id=f"p{i}", text=f"purge doc {i}",
                                namespace="mp") for i in range(4)])
    ds.delete_document("p1")
    assert ds.docs().maybe_merge(force=True)
    seg = ds.docs().segments[0]
    assert seg.doc_count == 3 and seg.num_tombstoned == 0
    res = ds.search("purge", [], 0, 10)
    assert sorted(ids(res)) == ["p0", "p2", "p3"]
    return res


def c_manager_lifecycle(pkg, tmp):
    cfg = pkg.config.ServerConfig.with_defaults(str(tmp), "main")
    mgr = pkg.manager.DatasetManager(cfg, **pkg.mgr_kw)
    assert mgr.list_namespaces() == ["main"]
    ds = mgr.get_or_create_dataset("extra")
    assert "extra" in mgr.list_namespaces()
    ds.ingest([rec(pkg, 1, "managed doc", ns="extra")])
    stats = mgr.get_all_stats()
    assert stats["extra"].docs_count == 1
    res = ds.search("managed", [], 0, 10)
    assert mgr.delete_namespace("extra")
    assert mgr.get_dataset("extra") is None
    assert not (tmp / "extra").exists()
    assert not mgr.delete_namespace("extra")
    return stats, res


def c_manager_filter_value_routing(pkg, tmp):
    cfg = pkg.config.ServerConfig.with_defaults(str(tmp), "main")
    mgr = pkg.manager.DatasetManager(cfg, **pkg.mgr_kw)
    mgr.get_or_create_dataset("routed")
    mgr.get_dataset("routed").ingest(
        [rec(pkg, 5, "routed content", ns="routed", data_type="csv")])
    vals = mgr.get_filter_values_at_path("/namespace/routed/data")
    assert vals == ["csv"]
    return vals


def c_terms_with_prefix(pkg, tmp):
    terms = seeded(pkg, tmp).docs().terms_with_prefix("text", "qu")
    assert "quick" in terms and all(t.startswith("qu") for t in terms)
    return terms


def c_search_many_batched(pkg, tmp):
    results = seeded(pkg, tmp).search_many(
        [("quick fox", []), ("lazy", []),
         ("", ["/namespace/testns/data/metal"])], 0, 10)
    assert len(results) == 3
    assert results[0] and results[0][0].id in ("doc1", "doc3")
    assert ids(results[1]) == ["doc2"] and ids(results[2]) == ["doc3"]
    return results


def c_compact_dataset(pkg, tmp):
    ds = pkg.Dataset("testns", tmp, **pkg.kw)
    for i in range(3):
        ds.ingest([rec(pkg, 50 + i, f"extra doc {i}")])
    ds.wait_compaction(timeout=60)
    assert len(ds.docs().segments) > 1
    before = ds.compact()
    assert before["docs"] > 1 and len(ds.docs().segments) == 1
    res = ds.search("extra", [], 0, 10)
    assert len(res) == 3
    return before, res


def c_multi_segment_scores_use_index_wide_stats(pkg, tmp):
    mgr = pkg.manager.DatasetManager.with_defaults(str(tmp), "multi",
                                                   **pkg.mgr_kw)
    ds = mgr.get_or_create_dataset("multi")
    rng = np.random.default_rng(9)
    words = [f"w{i}" for i in range(20)]

    def batch(n, base, pool):
        return [pkg.ObjectRecord(id=f"r{base + i}",
                                 text=" ".join(rng.choice(pool, size=6)))
                for i in range(n)]

    ds.batch_upsert(batch(400, 0, words))
    ds.search("w1", [], 0, 10)
    ds.batch_upsert(batch(400, 400, words[:4]))
    idx = ds.docs()
    segs = idx.searcher_segments()
    assert len(segs) >= 2
    q = pkg.query
    plan = q.QueryPlan(groups=(q.QueryGroup(q.Occur.SHOULD,
                                            (q.TermClause("text", "w1"),)),))
    hits = [(np.float32(h.score), h.segment_ord, h.doc)
            for h in idx.search_topk(plan, 10)]
    exp = [(np.float32(h.score), h.segment_ord, h.doc)
           for h in pkg.oracle.search(segs, plan, 10,
                                      pkg.oracle.IndexStats(segs))]
    assert hits == exp
    mgr.close()
    return hits


def c_legacy_jsonl_store_loads(pkg, tmp):
    ds = pkg.Dataset("legacy", tmp, **pkg.kw)
    ds.ingest([rec(pkg, 1, "legacy stored doc", ns="legacy")])
    mp_files = list((tmp / "legacy" / "docs").glob("seg-*.store.msgpack"))
    assert mp_files
    for mp in mp_files:
        stored = msgpack.unpackb(mp.read_bytes())
        legacy = mp.with_name(mp.name.replace(".store.msgpack",
                                              ".store.jsonl"))
        legacy.write_text("".join(json.dumps(d, ensure_ascii=False) + "\n"
                                  for d in stored))
        mp.unlink()
    ds2 = pkg.Dataset("legacy", tmp, **pkg.kw)
    res = ds2.search("legacy", [], 0, 10)
    assert ids(res) == ["doc1"] and ds2.stats().docs_count == 1
    return res


ENGINE_CASES = {name[2:]: fn for name, fn in globals().items()
                if name.startswith("c_")}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_case_matches_reference(case, tmp_path):
    fn = ENGINE_CASES[case]
    got = norm(fn(PORT, tmp_path / "port"))
    want = norm(fn(REF, tmp_path / "ref"))
    assert got == want


# -- tests/test_mutation_fuzz.py at a small size -------------------------------

WORDS = [f"w{i}" for i in range(18)]


def churn_and_fresh(pkg, tmp):
    """Random upsert / delete / compact churn and the same final corpus
    built fresh; returns both datasets."""
    rng = np.random.default_rng(41)
    churn = pkg.Dataset("churn", tmp / "churn", **pkg.kw)
    model = {}

    def batch(id_list):
        recs = []
        for i in id_list:
            text = " ".join(rng.choice(WORDS, size=int(rng.integers(3, 12))))
            facet = f"/cat/{int(rng.integers(0, 3))}"
            model[f"d{i}"] = (text, facet)
            recs.append(pkg.ObjectRecord(id=f"d{i}", text=text,
                                         namespace="churn", facets=[facet]))
        return recs

    churn.ingest(batch(range(300)))
    for _op in range(16):
        r = rng.random()
        if r < 0.55:
            churn.ingest(batch(np.unique(
                rng.integers(0, 450, size=int(rng.integers(5, 40))))))
        elif r < 0.85:
            live = sorted(model)
            for t in rng.choice(len(live), size=min(8, len(live)),
                                replace=False):
                churn.delete_document(live[int(t)])
                model.pop(live[int(t)], None)
        else:
            churn.compact()
    churn.compact()
    fresh = pkg.Dataset("fresh", tmp / "fresh", **pkg.kw)
    fresh.ingest([pkg.ObjectRecord(id=did, text=text, namespace="fresh",
                                   facets=[facet])
                  for did, (text, facet) in sorted(model.items())])
    assert churn.stats().docs_count == len(model)
    return churn, fresh


def test_churn_matches_fresh_build(tmp_path):
    """Churn, then every search equals the same corpus built fresh (the
    exact score sequence, and the id set of every score level but the
    last), and the port's churned dataset equals the reference's."""
    port_churn, port_fresh = churn_and_fresh(PORT, tmp_path / "port")
    ref_churn, _ref_fresh = churn_and_fresh(REF, tmp_path / "ref")
    rng = np.random.default_rng(43)
    for trial in range(20):
        q = " ".join(rng.choice(WORDS, size=int(rng.integers(1, 4)),
                                replace=False))
        filters = ([f"/cat/{int(rng.integers(0, 3))}"]
                   if rng.random() < 0.3 else [])
        got = port_churn.search(q, filters, 0, 20)
        want = port_fresh.search(q, filters, 0, 20)
        assert norm(got) == norm(ref_churn.search(q, filters, 0, 20))
        gs = [np.float32(h.score) for h in got]
        assert gs == [np.float32(h.score) for h in want], (trial, q)
        by_g, by_w = {}, {}
        for h in got:
            by_g.setdefault(np.float32(h.score), set()).add(h.id)
        for h in want:
            by_w.setdefault(np.float32(h.score), set()).add(h.id)
        for s, level in by_g.items():
            if s != gs[-1]:
                assert level == by_w.get(s), (trial, q, s)


@pytest.mark.parametrize("how", ["config", "env"])
def test_sharded_config_serves(tmp_path, monkeypatch, how):
    """shard_devices > 0 from a config dict or FUGU_SHARD_DEVICES builds
    the manager's mesh on its device, every namespace's docs index
    serves through it, and the results equal the reference's."""
    monkeypatch.setattr(PORT.named_index_module, "DEVICE_MIN_ENTRIES", 1)
    if how == "env":
        monkeypatch.setenv("FUGU_SHARD_DEVICES", "4")
        cfg = port_config.ServerConfig.with_defaults(str(tmp_path), "main")
        n = 4
    else:
        cfg = port_config.ServerConfig.from_dict(
            {"data_path": str(tmp_path), "default_namespace": "main",
             "shard_devices": 2})
        n = 2
    mgr = port_manager.DatasetManager(cfg, device="cpu")
    assert mgr._mesh is not None and mgr._mesh.size == n
    assert {d.type for d in mgr._mesh.devices} == {"cpu"}
    ds = mgr.default_dataset()
    assert ds.docs()._mesh is mgr._mesh
    seed(PORT, ds)
    want = seeded(REF, tmp_path / "ref")
    for q in ("quick", "fox OR dogs", "quick -silver"):
        assert norm(ds.search(q, [], 0, 10)) == norm(want.search(q, [], 0, 10))
    assert ds.docs().routes.get("sharded_small", 0) > 0, ds.docs().routes
    mgr.close()
