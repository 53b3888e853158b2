// The phrase kernel of the batched phrase engine: one sweep of the
// forward token stream that gives every phrase query of a batch, in
// each fine slice of each 512-doc block, its best phrase score and the
// integer class (tf << 8 | 255 - fid) of the doc that scores it.
//
// Replaces the TPU kernel fugu_tpu/ops/phrase_stream.py::_phrase_kernel
// (wrapper _phrase_callable).
//
// What bounds it on an H100: the per-row work, not device memory.  The
// stream is read once per 64-query tile (4 bytes a row, about 270 MB at
// 1M docs), but every row whose term is some query's first term starts
// a check of that query's later terms and, on a match, a shared-memory
// atomic on the doc's tf counter.
//
// Design: the grid is (64-query tile) x (512-doc block).  The TPU's
// one-hot compare of each shifted row against the union of the batch's
// terms and its matmuls against bf16 weight planes become a lookup: a
// term -> union slot table maps each row of a staged 2048-row chunk to
// its slot once, a table of 64-bit masks (one per union slot) names the
// tile's queries whose first term sits in that slot, and each anchor
// checks only those queries: slot j >= 1 matches if any of the rows
// anchor + j .. anchor + j + slop holds its slot (dead slots, -1, always
// match).  Only rows in the first BM_CHUNK - KGAP of a chunk are
// anchors; the chunk tail reappears at the head of the next chunk, so
// each anchor counts once and tf is the oracle's phrase tf.  Every read
// of a later row stays inside the chunk because kmax - 1 + smax <= KGAP.
// The tf of the block's docs for the tile's queries are int32 counters
// in shared memory, [512][64] = 128 KB (an f32 [512][256] tile, as the
// TPU keeps, would not fit the 227 KB a block may use).  The epilogue
// takes, per fine slice and query, the max of wp * (tf / (tf + cv)) in
// IEEE f32 (no contraction) over docs with tf > 0, and the max class
// among the docs at that max; empty and padded blocks give -inf and -1.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define BM_BLOCK_DOCS 512
#define BM_CHUNK 2048
#define KGAP 8
#define KMAX 8
#define TID_BITS 22
#define TID_MASK ((1 << TID_BITS) - 1)
#define U_MAX 512
#define QT 64
#define FINE 2
#define FINE_DOCS (BM_BLOCK_DOCS / FINE)
#define NT 512

__global__ void __launch_bounds__(NT) phrase_kernel(
    const int* __restrict__ offs,       // [nb_pad + 1] chunk offsets
    const int* __restrict__ tok,        // [n_tok] doc_local << 22 | tid
    long long n_tok,
    const float* __restrict__ cv,       // [nb_pad * 1024] BM25 denominator
    const int* __restrict__ fid,        // [nb_pad * 1024] fieldnorm ids
    const int* __restrict__ qterm,      // [b_pad, kmax] union slots, -1 dead
    int kmax,
    const int* __restrict__ qslop,      // [b_pad] slop
    int smax,
    const float* __restrict__ wp,       // [b_pad] phrase weight
    const int* __restrict__ slot_of,    // [n_terms] union slot, -1
    int n_terms, int b_pad,
    float* __restrict__ amax,           // [nb_pad, FINE, b_pad]
    int* __restrict__ acls) {           // [nb_pad, FINE, b_pad]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* qmask = (unsigned long long*)smem_raw;  // [U_MAX]
  int* tf = (int*)(qmask + U_MAX);                            // [512][QT]
  int* rslot = tf + BM_BLOCK_DOCS * QT;                       // [BM_CHUNK]
  int* rdoc = rslot + BM_CHUNK;                               // [BM_CHUNK]
  int* qt_s = rdoc + BM_CHUNK;                                // [QT][KMAX]
  int* qs_s = qt_s + QT * KMAX;                               // [QT]

  const int q0 = blockIdx.x * QT;
  const int j = blockIdx.y;

  for (int i = threadIdx.x; i < U_MAX; i += NT) qmask[i] = 0ull;
  for (int i = threadIdx.x; i < BM_BLOCK_DOCS * QT; i += NT) tf[i] = 0;
  for (int i = threadIdx.x; i < QT * KMAX; i += NT) {
    const int q = i / KMAX, jj = i % KMAX;
    qt_s[i] = jj < kmax ? qterm[(size_t)(q0 + q) * kmax + jj] : -1;
  }
  for (int q = threadIdx.x; q < QT; q += NT) {
    qs_s[q] = min(max(qslop[q0 + q], 0), smax);
  }
  __syncthreads();
  for (int q = threadIdx.x; q < QT; q += NT) {
    const int s = qt_s[q * KMAX];
    if (s >= 0 && s < U_MAX) atomicOr(&qmask[s], 1ull << q);
  }

  const int c0 = offs[j];
  const int c1 = offs[j + 1];
  for (int c = c0; c < c1; ++c) {
    __syncthreads();  // the previous chunk's rows are no longer read
    for (int r = threadIdx.x; r < BM_CHUNK; r += NT) {
      const long long idx = (long long)c * BM_CHUNK + r;
      const int v = idx < n_tok ? tok[idx] : TID_MASK;
      const int t = v & TID_MASK;
      int s = t < n_terms ? slot_of[t] : -1;
      if (s < 0 || s >= U_MAX) s = -1;
      rslot[r] = s;
      rdoc[r] = (int)((unsigned)v >> TID_BITS);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < BM_CHUNK - KGAP; p += NT) {
      const int s = rslot[p];
      if (s < 0) continue;
      unsigned long long m = qmask[s];
      const int d = rdoc[p];
      if (d >= BM_BLOCK_DOCS) continue;
      while (m) {
        const int q = __ffsll((long long)m) - 1;
        m &= m - 1;
        const int* qs = qt_s + q * KMAX;
        const int sl = qs_s[q];
        bool ok = true;
        for (int jj = 1; jj < kmax && ok; ++jj) {
          const int want = qs[jj];
          if (want < 0) continue;
          bool hit = false;
          for (int ss = 0; ss <= sl; ++ss) hit |= rslot[p + jj + ss] == want;
          ok = hit;
        }
        if (ok) atomicAdd(&tf[d * QT + q], 1);
      }
    }
  }
  __syncthreads();

  const size_t doc0 = (size_t)j * 1024;
  for (int p = threadIdx.x; p < QT * FINE; p += NT) {
    const int q = p % QT;
    const int f = p / QT;
    const float w = wp[q0 + q];
    float best = -CUDART_INF_F;
    int bcls = -1;
    for (int d = f * FINE_DOCS; d < (f + 1) * FINE_DOCS; ++d) {
      const int t = tf[d * QT + q];
      if (t <= 0) continue;
      const float tff = (float)t;
      const float sc =
          __fmul_rn(w, __fdiv_rn(tff, __fadd_rn(tff, cv[doc0 + d])));
      const int cls = t * 256 + (255 - fid[doc0 + d]);
      if (sc > best) {
        best = sc;
        bcls = cls;
      } else if (sc == best) {
        bcls = max(bcls, cls);
      }
    }
    const size_t o = ((size_t)j * FINE + f) * b_pad + q0 + q;
    amax[o] = best;
    acls[o] = bcls;
  }
}

extern "C" int fugu_phrase_smem_bytes() {
  return U_MAX * (int)sizeof(unsigned long long) +
         (BM_BLOCK_DOCS * QT + 2 * BM_CHUNK + QT * KMAX + QT) * (int)sizeof(int);
}

extern "C" int fugu_phrase(
    const int* offs, int nb_pad, const int* tok, long long n_tok,
    const float* cv, const int* fid, const int* qterm, int kmax,
    const int* qslop, int smax, const float* wp, const int* slot_of,
    int n_terms, int b_pad, float* amax, int* acls, void* stream) {
  if (b_pad % QT || kmax < 1 || kmax > KMAX || smax < 0 ||
      kmax - 1 + smax > KGAP || nb_pad > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = fugu_phrase_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      phrase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (nb_pad > 0 && b_pad > 0) {
    dim3 grid(b_pad / QT, nb_pad);
    phrase_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
        offs, tok, n_tok, cv, fid, qterm, kmax, qslop, smax, wp, slot_of,
        n_terms, b_pad, amax, acls);
  }
  return (int)cudaGetLastError();
}
