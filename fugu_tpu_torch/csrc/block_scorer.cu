// Block scorer: BM25 scoring of candidate 2048-doc blocks with boolean
// masks and tombstones, and the top k of each row, (score desc, doc asc).
//
// Replaces the TPU kernel fugu_tpu/ops/pallas_scorer.py::_scorer_kernel
// (:225) with its in-kernel top-128, _bitonic_topk_update (:103), and the
// XLA top_k that its wrapper build_scorer_call (:461) runs after it.
//
// What bounds it on an H100: device memory.  Each (row, block, clause)
// is a contiguous run of <= 2048 entries of e_doc and e_tffid (8 bytes an
// entry), read once, and each (row, block) reads the block's 2048
// tombstone flags (8 KB); the BM25 arithmetic is a handful of flops and
// one IEEE division an entry, and the outputs are k pairs a row.
//
// Design: two passes, launched together.  Pass 1 has one thread block of
// 256 threads per (row, block slot), on a flat grid of rows * nb_pad
// blocks (no 65,535-row limit), so a row over hundreds of blocks is
// spread over every SM and several blocks share an SM.  The block's 2048
// scores and clause-presence bits live in shared memory (16 KB).  Within
// one clause a doc appears at most once, so a clause scatters with plain
// shared-memory adds; clauses are visited in order with a barrier between
// them, so every doc's f32 sum is taken in clause order with __fadd_rn /
// __fmul_rn / __fdiv_rn (no FMA contraction) and equals the plain
// version's bit for bit.  After the masks and the tombstones, the block's
// top k is selected without sorting the 2048 pairs: a radix select of the
// order-preserving key bits (four 8-bit digits, a histogram in shared
// memory with warp-aggregated counts) finds the k-th score, a second one
// over the doc ids of the docs tied at it keeps the lowest, and only the
// <= k survivors are ordered, each by counting the survivors that rank
// before it.  The block's list goes to scratch [row, block slot, k].
// Pass 2 has one thread block per row and takes the same select over the
// row's nblocks * k listed candidates.  (score desc, doc asc) is a strict
// total order, so the two passes give the same top k as one select over
// the row's dense scores.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define BLOCK 2048
#define NT 256
#define NT_MERGE 512
#define MAX_K 128
#define INT_MAX_DOC 0x7fffffff
#define FULL 0xffffffffu

__device__ __forceinline__ int decode_fid(int fid) {
  // Lucene SmallFloat 4-bit decode (fieldnorm.FIELD_NORMS_TABLE)
  int j = fid - 24;
  int bits = j & 7;
  int shift = (j >> 3) - 1;
  int f4 = shift < 0 ? bits : ((bits | 8) << shift);
  return fid < 24 ? fid : 24 + f4;
}

// f32 bits -> u32 of the same order (the plain version's _order_keys)
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

struct SelSmem {
  unsigned hist[256];
  unsigned warp_sum[32];
  unsigned digit, rank, n_eq;
  int n_valid, count;
  unsigned key[MAX_K];
  int doc[MAX_K];
};

// the k-th largest (1 <= k <= the number of valid elements) of the keys
// that get(i, key) gives for the valid elements i < n.  Afterwards
// sm.n_eq holds how many elements have that key, and sm.rank how many of
// them the top k takes.
template <int NTH, typename Get>
__device__ unsigned radix_select(int n, int k, const Get& get, SelSmem& sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned prefix = 0, pmask = 0;
  unsigned kk = (unsigned)k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += NTH) sm.hist[i] = 0u;
    __syncthreads();
    for (int base = 0; base < n; base += NTH) {  // uniform trip count
      const int i = base + threadIdx.x;
      unsigned key = 0;
      const bool v = i < n && get(i, key) && (key & pmask) == prefix;
      const unsigned dig = v ? (key >> shift) & 255u : 256u;
      const unsigned peers = __match_any_sync(FULL, dig);
      if (v && lane == __ffs(peers) - 1) atomicAdd(&sm.hist[dig], __popc(peers));
    }
    __syncthreads();
    // inclusive count of the bins from the top digit down
    const unsigned c = threadIdx.x < 256 ? sm.hist[255 - threadIdx.x] : 0u;
    unsigned incl = c;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned x = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += x;
    }
    if (lane == 31) sm.warp_sum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += sm.warp_sum[w];
    const unsigned excl = incl - c;
    if (threadIdx.x < 256 && excl < kk && kk <= incl) {
      sm.digit = 255u - threadIdx.x;
      sm.rank = kk - excl;
      sm.n_eq = c;
    }
    __syncthreads();
    prefix |= sm.digit << shift;
    pmask |= 255u << shift;
    kk = sm.rank;
    __syncthreads();  // hist, warp_sum and digit are rewritten
  }
  return prefix;
}

template <typename Src>
struct ScoreKey {
  Src src;
  __device__ bool operator()(int i, unsigned& key) const {
    float s;
    int d;
    if (!src(i, s, d)) return false;
    key = order_key(s);
    return true;
  }
};

// among the elements whose score key is t: the lower the doc, the larger
template <typename Src>
struct TieKey {
  Src src;
  unsigned t;
  __device__ bool operator()(int i, unsigned& key) const {
    float s;
    int d;
    if (!src(i, s, d) || order_key(s) != t) return false;
    key = ~(unsigned)d;
    return true;
  }
};

// Writes the top k of the n_valid valid elements of src, (score desc, doc
// asc), to out_key / out_doc [k], padded with (-inf, INT_MAX).
template <int NTH, typename Src>
__device__ void select_topk(const Src& src, int n, int k, int n_valid,
                            SelSmem& sm, float* out_key, int* out_doc) {
  const bool take_all = n_valid <= k;
  unsigned t = 0, tie_min = 0;  // keep key > t, or key == t and ~doc >= tie_min
  if (!take_all) {
    t = radix_select<NTH>(n, k, ScoreKey<Src>{src}, sm);
    const unsigned need = sm.rank;
    if (need < sm.n_eq) {
      tie_min = radix_select<NTH>(n, (int)need, TieKey<Src>{src, t}, sm);
    }
  }
  if (threadIdx.x == 0) sm.count = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += NTH) {
    float s;
    int d;
    if (!src(i, s, d)) continue;
    const unsigned key = order_key(s);
    if (take_all || key > t || (key == t && ~(unsigned)d >= tie_min)) {
      const int p = atomicAdd(&sm.count, 1);
      sm.key[p] = key;
      sm.doc[p] = d;
    }
  }
  __syncthreads();
  const int cnt = sm.count;
  for (int i = threadIdx.x; i < k; i += NTH) {
    if (i < cnt) {
      const unsigned ki = sm.key[i];
      const int di = sm.doc[i];
      int r = 0;
      for (int j = 0; j < cnt; ++j) {
        const unsigned kj = sm.key[j];
        r += kj > ki || (kj == ki && sm.doc[j] < di);
      }
      out_key[r] = key_float(ki);
      out_doc[r] = di;
    } else {
      out_key[i] = -CUDART_INF_F;
      out_doc[i] = INT_MAX_DOC;
    }
  }
}

__device__ __forceinline__ void add_valid(SelSmem& sm, int local) {
  local = __reduce_add_sync(FULL, local);
  if ((threadIdx.x & 31) == 0) atomicAdd(&sm.n_valid, local);
}

struct BlockSrc {
  const float* score;
  int base;
  __device__ bool operator()(int i, float& s, int& d) const {
    s = score[i];
    d = base + i;
    return s > -CUDART_INF_F;
  }
};

struct ListSrc {
  const float* key;
  const int* doc;
  __device__ bool operator()(int i, float& s, int& d) const {
    s = key[i];
    d = doc[i];
    return s > -CUDART_INF_F;
  }
};

// pass 1: one thread block per (row, block slot), row-major on grid.x
__global__ void __launch_bounds__(NT) block_topk_kernel(
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
    int nb_pad, int t_pad, int need_bits, int k,
    float* __restrict__ scr_key,        // [B, nb_pad, k]
    int* __restrict__ scr_doc) {        // [B, nb_pad, k]
  __shared__ float s_score[BLOCK];
  __shared__ int s_bits[BLOCK];
  __shared__ SelSmem sel;

  const int b = blockIdx.x / nb_pad;
  const int jj = blockIdx.x - b * nb_pad;
  const int tid = threadIdx.x;
  if (jj >= nblocks[b]) return;  // uniform across the thread block
  const unsigned must = (unsigned)masks[b * 3 + 0];
  const unsigned mustnot = (unsigned)masks[b * 3 + 1];
  const unsigned should = (unsigned)masks[b * 3 + 2];
  const int base = block_ids[b * nb_pad + jj] * BLOCK;

  for (int i = tid; i < BLOCK; i += NT) {
    s_score[i] = 0.f;
    s_bits[i] = 0;
  }
  if (tid == 0) sel.n_valid = 0;
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

  int local = 0;
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
    s_score[i] = m ? s : -CUDART_INF_F;
    local += m;
  }
  add_valid(sel, local);
  __syncthreads();
  const size_t o = ((size_t)b * nb_pad + jj) * k;
  select_topk<NT>(BlockSrc{s_score, base}, BLOCK, k, sel.n_valid, sel,
                  scr_key + o, scr_doc + o);
}

// pass 2: one thread block per row over its nblocks lists
__global__ void __launch_bounds__(NT_MERGE) merge_topk_kernel(
    const int* __restrict__ nblocks, int nb_pad, int k,
    const float* __restrict__ scr_key, const int* __restrict__ scr_doc,
    float* __restrict__ out_key,        // [B, k]
    int* __restrict__ out_doc) {        // [B, k]
  __shared__ SelSmem sel;
  const int b = blockIdx.x;
  const int n = nblocks[b] * k;
  const size_t o = (size_t)b * nb_pad * k;
  const ListSrc src{scr_key + o, scr_doc + o};
  if (threadIdx.x == 0) sel.n_valid = 0;
  __syncthreads();
  int local = 0;
  for (int i = threadIdx.x; i < n; i += NT_MERGE) {
    float s;
    int d;
    local += src(i, s, d);
  }
  add_valid(sel, local);
  __syncthreads();
  select_topk<NT_MERGE>(src, n, k, sel.n_valid, sel, out_key + (size_t)b * k,
                        out_doc + (size_t)b * k);
}

extern "C" int fugu_block_scorer(
    const int* nblocks, const int* block_ids, const int* starts,
    const int* counts, const float* weights, const float* c1, const float* c2,
    const int* gbits, const int* masks, const int* e_doc, const int* e_tffid,
    const int* tomb, int n_rows, int nb_pad, int t_pad, int need_bits, int k,
    float* scr_key, int* scr_doc, float* out_key, int* out_doc,
    void* stream) {
  if (k < 1 || k > MAX_K || (long long)n_rows * nb_pad > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_rows > 0 && nb_pad > 0) {
    block_topk_kernel<<<n_rows * nb_pad, NT, 0, (cudaStream_t)stream>>>(
        nblocks, block_ids, starts, counts, weights, c1, c2, gbits, masks,
        e_doc, e_tffid, tomb, nb_pad, t_pad, need_bits, k, scr_key, scr_doc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    merge_topk_kernel<<<n_rows, NT_MERGE, 0, (cudaStream_t)stream>>>(
        nblocks, nb_pad, k, scr_key, scr_doc, out_key, out_doc);
  }
  return (int)cudaGetLastError();
}
