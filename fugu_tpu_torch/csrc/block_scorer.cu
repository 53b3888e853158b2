// Block scorer: BM25 scoring of candidate 2048-doc blocks with boolean
// masks, tombstones and either dense masked output or a running top-128.
//
// Replaces the TPU kernel fugu_tpu/ops/pallas_scorer.py::_scorer_kernel
// (wrapper build_scorer_call) together with its in-kernel top-128,
// _bitonic_topk_update.
//
// What bounds it on an H100: the posting reads.  Each (row, block,
// clause) is a contiguous run of <= 2048 entries of e_doc and e_tffid
// (8 bytes an entry), read once; the BM25 arithmetic per entry is a
// handful of flops and one IEEE division.  The scatter of the entries
// into the block's 2048 scores is the other cost.
//
// Design: one thread block per kernel row, looping over the row's
// blocks in the order given.  The block's 2048 scores and the clause
// presence bits live in shared memory (16 KB).  Within one clause a doc
// appears at most once, so a clause scatters with plain shared-memory
// adds and no collisions; clauses are visited in order with a barrier
// between them, so every doc's f32 sum is taken in clause order and the
// result is deterministic.  The TPU's one-hot matmuls, three-way bf16
// split and aligned DMA windows are gone: they existed only because
// Mosaic has no scatter.  The contribution keeps the association
// weight * (tf / denom) with round-to-nearest intrinsics (no FMA
// contraction), so ties stay ties.  In top-128 mode each block that can
// still beat the running kth (block max > kth, strictly, as on the TPU)
// is bitonic-sorted in shared memory by (score desc, doc asc) and
// merged into the running list by a rank merge; other blocks cost one
// reduction.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define BLOCK 2048
#define K_OUT 128
#define NT 1024
#define INT_MAX_DOC 0x7fffffff

__device__ __forceinline__ int decode_fid(int fid) {
  // Lucene SmallFloat 4-bit decode (fieldnorm.FIELD_NORMS_TABLE)
  int j = fid - 24;
  int bits = j & 7;
  int shift = (j >> 3) - 1;
  int f4 = shift < 0 ? bits : ((bits | 8) << shift);
  return fid < 24 ? fid : 24 + f4;
}

// (score desc, doc asc): true when (ka, da) ranks before (kb, db)
__device__ __forceinline__ bool wins(float ka, int da, float kb, int db) {
  return ka > kb || (ka == kb && da < db);
}

__global__ void __launch_bounds__(NT) block_scorer_kernel(
    const int* __restrict__ nblocks,    // [B]
    const int* __restrict__ block_ids,  // [B, nb_pad]
    const int* __restrict__ starts,     // [B, nb_pad, t_pad]
    const int* __restrict__ counts,     // [B, nb_pad, t_pad]
    const float* __restrict__ weights,  // [B, t_pad]
    const float* __restrict__ c1,       // [B, t_pad]
    const float* __restrict__ c2,       // [B, t_pad]
    const int* __restrict__ gbits,      // [B, t_pad] group index, -1 none
    const int* __restrict__ masks,      // [B, 3] must, mustnot, should
    const int* __restrict__ e_doc,      // [E]
    const int* __restrict__ e_tffid,    // [E] tf | fid << 24
    const int* __restrict__ tomb,       // [>= n_blocks * BLOCK]
    int nb_pad, int t_pad, int need_bits, int topk,
    float* __restrict__ out_scores,     // dense: [B, nb_pad * BLOCK]
    float* __restrict__ out_key,        // top-128: [B, K_OUT]
    int* __restrict__ out_doc) {        // top-128: [B, K_OUT]
  __shared__ float s_score[BLOCK];
  __shared__ int s_bits[BLOCK];
  __shared__ float s_key[BLOCK];
  __shared__ int s_doc[BLOCK];
  __shared__ float r_key[K_OUT];
  __shared__ int r_doc[K_OUT];
  __shared__ float m_key[K_OUT];
  __shared__ int m_doc[K_OUT];
  __shared__ float s_red[NT / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nb = nblocks[b];
  const unsigned must = (unsigned)masks[b * 3 + 0];
  const unsigned mustnot = (unsigned)masks[b * 3 + 1];
  const unsigned should = (unsigned)masks[b * 3 + 2];

  if (topk && tid < K_OUT) {
    r_key[tid] = -CUDART_INF_F;
    r_doc[tid] = INT_MAX_DOC;
  }

  for (int jj = 0; jj < nb; ++jj) {
    const int base = block_ids[b * nb_pad + jj] * BLOCK;
    for (int i = tid; i < BLOCK; i += NT) {
      s_score[i] = 0.f;
      s_bits[i] = 0;
    }
    __syncthreads();

    const size_t tab = ((size_t)b * nb_pad + jj) * t_pad;
    for (int t = 0; t < t_pad; ++t) {
      const int st = starts[tab + t];
      const int cnt = counts[tab + t];
      if (cnt <= 0) continue;  // uniform across the thread block
      const float w = weights[b * t_pad + t];
      const float a1 = c1[b * t_pad + t];
      const float a2 = c2[b * t_pad + t];
      const int g = gbits[b * t_pad + t];
      const int gbit = g >= 0 ? (int)(1u << g) : 0;
      for (int e = tid; e < cnt; e += NT) {
        const int doc = e_doc[st + e];
        const int pk = e_tffid[st + e];
        const float tf = (float)(pk & 0xFFFFFF);
        const int fid = (pk >> 24) & 0xFF;
        const float denom =
            __fadd_rn(__fadd_rn(tf, a1), __fmul_rn(a2, (float)decode_fid(fid)));
        const float contrib = __fmul_rn(w, __fdiv_rn(tf, denom));
        const int loc = doc - base;
        if ((unsigned)loc < BLOCK) {
          s_score[loc] = __fadd_rn(s_score[loc], contrib);
          if (need_bits) s_bits[loc] |= gbit;
        }
      }
      __syncthreads();
    }

    float lmax = -CUDART_INF_F;
    for (int i = tid; i < BLOCK; i += NT) {
      const float s = s_score[i];
      bool m;
      if (need_bits) {
        const unsigned pb = (unsigned)s_bits[i];
        m = (pb & (must | should)) != 0 && (pb & must) == must &&
            (pb & mustnot) == 0 && ((pb & should) != 0 || should == 0);
      } else {
        m = s > 0.f;  // pure-SHOULD: every scored doc matches
      }
      m = m && tomb[base + i] == 0;
      const float v = m ? s : -CUDART_INF_F;
      if (topk) {
        s_key[i] = v;
        s_doc[i] = base + i;
        lmax = fmaxf(lmax, v);
      } else {
        out_scores[((size_t)b * nb_pad + jj) * BLOCK + i] = v;
      }
    }
    if (!topk) {
      __syncthreads();  // s_score is zeroed for the next block
      continue;
    }

    // block max; skip the block unless it can beat the running kth
    for (int off = 16; off > 0; off >>= 1)
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
    if ((tid & 31) == 0) s_red[tid >> 5] = lmax;
    __syncthreads();
    if (tid < 32) {
      float v = tid < NT / 32 ? s_red[tid] : -CUDART_INF_F;
      for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (tid == 0) s_red[0] = v;
    }
    __syncthreads();
    const float bm = s_red[0];
    const float kth = r_key[K_OUT - 1];
    if (!(bm > kth)) {
      __syncthreads();
      continue;
    }

    // bitonic sort of the block's (key, doc) pairs, (score desc, doc asc);
    // one compare-exchange per thread per stage
    for (int k = 2; k <= BLOCK; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        const int i = 2 * j * (tid / j) + (tid % j);
        const int p = i + j;
        const bool desc = (i & k) == 0;
        const float ki = s_key[i], kp = s_key[p];
        const int di = s_doc[i], dp = s_doc[p];
        const bool partner_first = wins(kp, dp, ki, di);
        if (desc == partner_first) {
          s_key[i] = kp;
          s_doc[i] = dp;
          s_key[p] = ki;
          s_doc[p] = di;
        }
        __syncthreads();
      }
    }

    // rank merge of the block's top K_OUT (s_key[0..]) with the running
    // list: an element's merged position is its own index plus the
    // number of elements of the other list that rank before it (docs of
    // different blocks never compare equal, so positions are distinct)
    if (tid < 2 * K_OUT) {
      const bool from_block = tid < K_OUT;
      const int i = from_block ? tid : tid - K_OUT;
      const float key = from_block ? s_key[i] : r_key[i];
      const int doc = from_block ? s_doc[i] : r_doc[i];
      const float* ok = from_block ? r_key : s_key;
      const int* od = from_block ? r_doc : s_doc;
      int lo = 0, hi = K_OUT;  // count of the other list's prefix ahead
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (wins(ok[mid], od[mid], key, doc))
          lo = mid + 1;
        else
          hi = mid;
      }
      const int pos = i + lo;
      if (pos < K_OUT) {
        m_key[pos] = key;
        m_doc[pos] = doc;
      }
    }
    __syncthreads();
    if (tid < K_OUT) {
      r_key[tid] = m_key[tid];
      r_doc[tid] = m_doc[tid];
    }
    __syncthreads();
  }

  if (topk) {
    __syncthreads();
    if (tid < K_OUT) {
      const float k = r_key[tid];
      out_key[(size_t)b * K_OUT + tid] = k;
      out_doc[(size_t)b * K_OUT + tid] = k > -CUDART_INF_F ? r_doc[tid] : INT_MAX_DOC;
    }
  } else {
    // slots past the row's block count hold no candidates
    for (size_t i = (size_t)nb * BLOCK + tid; i < (size_t)nb_pad * BLOCK; i += NT)
      out_scores[(size_t)b * nb_pad * BLOCK + i] = -CUDART_INF_F;
  }
}

extern "C" int fugu_block_scorer(
    const int* nblocks, const int* block_ids, const int* starts,
    const int* counts, const float* weights, const float* c1, const float* c2,
    const int* gbits, const int* masks, const int* e_doc, const int* e_tffid,
    const int* tomb, int n_rows, int nb_pad, int t_pad, int need_bits,
    int topk, float* out_scores, float* out_key, int* out_doc,
    void* stream) {
  if (n_rows > 0) {
    block_scorer_kernel<<<n_rows, NT, 0, (cudaStream_t)stream>>>(
        nblocks, block_ids, starts, counts, weights, c1, c2, gbits, masks,
        e_doc, e_tffid, tomb, nb_pad, t_pad, need_bits, topk, out_scores,
        out_key, out_doc);
  }
  return (int)cudaGetLastError();
}
