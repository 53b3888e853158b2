"""What each kernel call must move and do, and the card's peaks.

``scorer_cost``, ``phasea_cost`` and ``phrase_cost`` are frozen from
``chip_smoke.py`` (lines 479-535) at commit
23dc844b70300e262b1ac425b78377cec020fed5; each takes the operands of one
call of the kernel wrapper (``block_scorer.score_rows``,
``batch_scorer.phasea``, ``phrase_stream.phrase_stream``) and counts
each input byte once.  The layout constants they need are copied too.
"""

from __future__ import annotations

#: NVIDIA's data sheet for the H100 SXM (dense, at 700 W): HBM bytes/s
#: and float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

#: layout constants of ``fugu_tpu_torch`` at that commit
#: (``index/segment.py`` BM_BLOCK_DOCS, BM_CHUNK; ``ops/phrase_stream.py``
#: FINE_PER_BLOCK, TID_MASK), checked against the program by a test
BM_BLOCK_DOCS = 512
BM_CHUNK = 2048
FINE_PER_BLOCK = 2
TID_MASK = (1 << 22) - 1


def bound_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the longer of the bytes at
    the memory's peak and the operations at the float32 peak."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)


def scorer_cost(args):
    """(bytes, operations) one block-scorer call must move and do: each
    posting run it lists (doc and tf | fid, 8 bytes an entry) and each
    block it lists (2048 tombstone flags) once, however many of its rows
    share them, and the k (score, doc) pairs a row; six operations a
    posting of a row (two adds, two multiplies, a division and the
    sum)."""
    import torch

    nblocks, block_ids, starts, counts, *_rest, k = args
    listed = (torch.arange(block_ids.shape[1], device=counts.device)[None, :]
              < nblocks[:, None])
    run = listed[:, :, None] & (counts > 0)
    # a run is one clause's entries in one block: its start names it
    firsts, inv = torch.unique(starts[run], return_inverse=True)
    run_len = torch.zeros_like(firsts).scatter_(0, inv, counts[run])
    distinct = int(run_len.sum())
    blocks = torch.unique(block_ids[listed]).numel()
    nbytes = distinct * 8 + blocks * 2048 * 4 + nblocks.numel() * k * 8
    return nbytes, 6 * int(counts[run].sum())


def phasea_cost(args):
    """(bytes, operations) one phase-A call must move and do: its real
    entries (doc, term id and bf16 contribution, 10 bytes each; the chunk
    padding is no work), W's nonzero lists and the maxima; two operations
    per nonzero product of W's row and a live entry."""
    import torch

    doc_offs, _doc, tid, _con, nz_off, nz, _lanes, slot_of, nm, fine = args
    real = int((doc_offs[:, -1] - doc_offs[:, 0]).sum())
    t = tid[:int(doc_offs[-1, -1])].long()
    n_terms = slot_of.numel()
    slot = torch.where((t >= 0) & (t < n_terms),
                       slot_of[t.clamp(0, n_terms - 1)], -1).long()
    per_slot = (nz_off[1:] - nz_off[:-1]).long()
    products = int(per_slot[slot[slot >= 0]].sum())
    out = doc_offs.shape[0] * fine * nm.numel() * 4
    return real * 10 + (nz_off.numel() + nz.numel()) * 4 + out, 2 * products


def phrase_cost(args):
    """(bytes, operations) one phrase-kernel call must move and do: the
    stream's real token rows (4 bytes each; sentinel rows are no work),
    each streamed block's 512 docs' ``cv`` and ``fid`` and the maxima
    and classes; one term lookup a token.  ``doc_row`` is layout the
    kernel reads to walk whole docs, not work: it is not counted."""
    offs, _doc_row, tok, _cv, _fid, qterm, *_rest = args
    rows = tok[:int(offs[-1]) * BM_CHUNK]
    real = int(((rows & TID_MASK) != TID_MASK).sum())
    streamed = int((offs[1:] > offs[:-1]).sum())
    out = (offs.numel() - 1) * FINE_PER_BLOCK * qterm.shape[0] * 8
    return real * 4 + streamed * BM_BLOCK_DOCS * 8 + out, real


COSTS = {"phase_a": phasea_cost, "block_scorer": scorer_cost,
         "phrase": phrase_cost}
