"""Fieldnorm (document length) byte codec — Tantivy/Lucene parity.

Tantivy quantizes each document's per-field token count to one byte using
Lucene's ``SmallFloat`` 4-bit-mantissa scheme (tantivy ``fieldnorm::code``,
"this mapping is the same as Lucene's"); BM25 then reads lengths back
through the decode table.  Exact parity of this quantization is required
for bit-for-bit BM25 score parity (SURVEY.md §7 "Hard parts").

Scheme: ids 0..23 are exact; id >= 24 decodes as ``24 + f4(id - 24)``
where ``f4`` is a 3-bit-mantissa/implicit-bit float:
``f4(j) = bits            if shift == -1``
``f4(j) = (bits|8)<<shift otherwise`` with ``bits = j & 7``,
``shift = (j >> 3) - 1``.  Values 0..40 round-trip exactly.

Encoding maps a token count to the largest id whose decoded value does
not exceed it (truncation, not rounding).
"""

from __future__ import annotations

import numpy as np


def _f4_decode(j: int) -> int:
    bits = j & 0x07
    shift = (j >> 3) - 1
    return bits if shift == -1 else (bits | 0x08) << shift


#: FIELD_NORMS_TABLE[id] == decoded fieldnorm for that id (256 entries).
FIELD_NORMS_TABLE: np.ndarray = np.array(
    [i if i < 24 else 24 + _f4_decode(i - 24) for i in range(256)], dtype=np.int64
)
assert FIELD_NORMS_TABLE[40] == 40 and np.all(np.diff(FIELD_NORMS_TABLE) > 0)


def fieldnorm_to_id(fieldnorm: int) -> int:
    """Encode a token count into its one-byte id (truncating)."""
    idx = int(np.searchsorted(FIELD_NORMS_TABLE, fieldnorm, side="right")) - 1
    return max(idx, 0)


def id_to_fieldnorm(fid: int) -> int:
    """Decode a one-byte id back to the quantized token count."""
    return int(FIELD_NORMS_TABLE[fid])


def fieldnorms_to_ids(fieldnorms: np.ndarray) -> np.ndarray:
    """Vectorized encode (uint8 output)."""
    idx = np.searchsorted(FIELD_NORMS_TABLE, fieldnorms, side="right") - 1
    return np.maximum(idx, 0).astype(np.uint8)


def ids_to_fieldnorms(fids: np.ndarray) -> np.ndarray:
    """Vectorized decode."""
    return FIELD_NORMS_TABLE[np.asarray(fids, dtype=np.int64)]


def decode_fid_arithmetic(fid, xp=np):
    """Branch-free arithmetic decode, identical to FIELD_NORMS_TABLE[fid].

    ``xp`` selects the array namespace: numpy by default, or jax.numpy
    for use on tracers inside jit/Pallas kernels (ops/scoring._decode_fid
    wraps this with xp=jnp — ONE implementation, no drift).
    """
    j = fid - 24
    bits = j & 0x07
    shift = (j >> 3) - 1
    f4 = xp.where(shift < 0, bits, (bits | 0x08) << xp.maximum(shift, 0))
    return xp.where(fid < 24, fid, 24 + f4)
