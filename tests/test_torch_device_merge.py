"""The port's device merge (fugu_tpu_torch/ops/device_merge.py) on CPU
tensors: the merged entry pack must equal ``merged.device_pack("cpu")``,
the pack the host merge would upload, element for element, and its
entries must equal the reference's device merge (JAX on the CPU) on the
same segments.  The cases are the reference's (tests/test_device_merge.py)
plus a source with no docs, and the attached pack's residency."""

import numpy as np
import pytest
import torch

from fugu_tpu.index.merge import merge_segments as ref_merge_segments
from fugu_tpu.index.schema import SCHEMAS as REF_SCHEMAS
from fugu_tpu.index.schema import IndexType as RefIndexType
from fugu_tpu.index.segment import SegmentBuilder as RefSegmentBuilder
from fugu_tpu.ops import device_merge as ref_device_merge
from fugu_tpu_torch.index.merge import merge_segments
from fugu_tpu_torch.index.schema import SCHEMAS, IndexType
from fugu_tpu_torch.index.segment import DOC_SENTINEL, SegmentBuilder
from fugu_tpu_torch.ops import device_merge, residency

CPU = torch.device("cpu")
DOCS = SCHEMAS[IndexType.DOCS]
REF_DOCS = REF_SCHEMAS[RefIndexType.DOCS]


def build_pair(rng, n_docs, vocab, prefix):
    """The same segment built by the port and by the reference."""
    docs = []
    for d in range(n_docs):
        words = rng.choice(vocab, size=int(rng.integers(3, 12)))
        facets = [f"/namespace/ns{int(rng.integers(0, 3))}", "/type/a/b"]
        docs.append(({"text": [" ".join(words)], "id": [f"{prefix}{d}"]},
                     facets, {"id": f"{prefix}{d}"}))
    segs = []
    for builder in (SegmentBuilder(DOCS), RefSegmentBuilder(REF_DOCS)):
        for fields, facets, stored in docs:
            builder.add_document(fields, facets=facets, stored=stored)
        segs.append(builder.build())
    return segs


def kill(pairs, rng, frac):
    for port, ref in pairs:
        n = int(port.doc_count * frac)
        dead = rng.choice(port.doc_count, size=n, replace=False)
        port.tombstones[dead] = True
        ref.tombstones[dead] = True


def assert_pack_equal(got, want):
    for name in ("e_doc", "e_tffid", "tomb"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype == torch.int32, name
        assert torch.equal(g, w), name


def merge_both(pairs):
    """(port merged, port plan, port entries) and the reference's
    device-merged entries as numpy, over the same sources."""
    port = [p for p, _r in pairs]
    ref = [r for _p, r in pairs]
    merged, plan = merge_segments(port, DOCS, return_plan=True)
    entries = device_merge.device_merge_entries(port, plan, merged, CPU)
    r_merged, r_plan = ref_merge_segments(ref, REF_DOCS, return_plan=True)
    r_entries = ref_device_merge.device_merge_entries(ref, r_plan, r_merged)
    return merged, plan, entries, [np.asarray(a) for a in r_entries]


def check_against_reference(merged, entries, ref_entries):
    n = merged.n_entries
    for got, want in zip(entries, ref_entries):
        np.testing.assert_array_equal(got[:n].numpy(), want[:n])
    # past the postings: the host merge's sentinel padding, nothing else
    assert bool((entries[0][n:] == int(DOC_SENTINEL)).all())
    assert bool((entries[1][n:] == 0).all())


@pytest.mark.parametrize("n_segs", [2, 3])
def test_device_merge_matches_host_pack(n_segs):
    rng = np.random.default_rng(7)
    vocab = [f"t{i}" for i in range(80)]
    pairs = [build_pair(rng, 60 + 30 * i, vocab, f"s{i}d")
             for i in range(n_segs)]
    kill(pairs, rng, 0.2)
    before = device_merge.launches
    merged, _plan, entries, ref_entries = merge_both(pairs)
    assert device_merge.launches == before + 1
    want = merged.device_pack(CPU)
    assert entries[0].shape == (len(merged.e_doc),)
    assert torch.equal(entries[0], want.e_doc)
    assert torch.equal(entries[1], want.e_tffid)
    check_against_reference(merged, entries, ref_entries)


def test_racing_delete_lands_in_tomb_only():
    """A delete forwarded after the merge shows in the attached pack's
    tombstone flags, while the entries stay snapshot-consistent."""
    rng = np.random.default_rng(3)
    vocab = [f"w{i}" for i in range(40)]
    pairs = [build_pair(rng, 50, vocab, f"r{i}d") for i in range(2)]
    segs = [p for p, _r in pairs]
    snaps = [s.tombstones.copy() for s in segs]
    merged, plan = merge_segments(segs, DOCS, tombstones=snaps,
                                  return_plan=True)
    entries = device_merge.device_merge_entries(segs, plan, merged, CPU)
    # the racing delete, forwarded the way the compactor does
    segs[0].delete_by_term("id", "r0d7")
    newly = segs[0].tombstones & ~snaps[0]
    merged.tombstones[plan.remaps[0][np.nonzero(newly)[0]]] = True

    device_merge.attach_device_pack(merged, entries)
    attached = merged._device_pack
    merged._device_pack = None
    assert_pack_equal(attached, merged.device_pack(CPU))
    assert int(attached.tomb.sum()) == 1
    assert attached.tomb.shape == (2048,)


@pytest.mark.parametrize("case", ["fully_deleted", "no_docs", "all_dead"])
def test_empty_and_fully_deleted_sources(case):
    rng = np.random.default_rng(11)
    vocab = [f"v{i}" for i in range(20)]
    a = build_pair(rng, 30, vocab, "ea")
    b = build_pair(rng, 0 if case == "no_docs" else 25, vocab, "eb")
    b[0].tombstones[:] = True
    b[1].tombstones[:] = True
    if case == "all_dead":
        a[0].tombstones[:] = True
        a[1].tombstones[:] = True
    merged, _plan, entries, ref_entries = merge_both([a, b])
    want = merged.device_pack(CPU)
    assert torch.equal(entries[0], want.e_doc)
    assert torch.equal(entries[1], want.e_tffid)
    check_against_reference(merged, entries, ref_entries)
    assert merged.doc_count == (0 if case == "all_dead" else 30)


def test_attached_pack_is_reserved_in_residency(monkeypatch):
    """The attached pack counts against the device budget like an
    uploaded one, and an eviction drops it from the segment."""
    residency.reset_for_test()
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", "off")
    rng = np.random.default_rng(5)
    vocab = [f"u{i}" for i in range(60)]
    pairs = [build_pair(rng, 80, vocab, f"q{i}d") for i in range(2)]
    kill(pairs, rng, 0.1)
    segs = [p for p, _r in pairs]
    merged, plan = merge_segments(segs, DOCS, return_plan=True)
    entries = device_merge.device_merge_entries(segs, plan, merged, CPU)
    device_merge.attach_device_pack(merged, entries)
    key = ("entry", id(merged))
    assert residency.contains(key)
    pack = merged._device_pack
    nbytes = pack.e_doc.nbytes + pack.e_tffid.nbytes + pack.tomb.nbytes
    assert residency._entries[key].nbytes == nbytes
    assert residency._entries[key].kind == "entry"
    # a cached pack is only touched, not re-uploaded
    assert merged.device_pack(CPU) is pack
    # a budget below what is resident evicts the least recently used
    # packs, this one included, through the segment's evict callback
    monkeypatch.setenv("FUGU_DEVICE_MEM_BUDGET", str(nbytes))
    other = build_pair(rng, 40, vocab, "o")[0]
    other.device_pack(CPU)
    assert not residency.contains(key)
    assert merged._device_pack is None
    residency.reset_for_test()
