// The phrase kernel of the batched phrase engine: one sweep of the
// forward token stream that gives every phrase query of a batch, in
// each fine slice of each 512-doc block, its best phrase score and the
// integer class (tf << 8 | 255 - fid) of the doc that scores it.
//
// Replaces the TPU kernel fugu_tpu/ops/phrase_stream.py::_phrase_kernel
// (fugu_tpu/ops/phrase_stream.py:539, wrapper _phrase_callable at :702).
//
// What bounds it on an H100: the per-row work, far more than device
// memory.  The stream is 4 bytes a row (about 0.22 GB of real rows at
// 1M docs, 0.07 ms at 3.35 TB/s), but every row goes through a gather
// of its term's union slot and a handful of shared-memory and shuffle
// instructions, and every row whose term is some query's first term is
// an anchor for each such query (with Zipf-headed batches about 1.6
// anchor-query pairs a row, unevenly spread: a head term may open 200
// queries).  Timed variants on the card point at the throughput of
// those shared-memory and shuffle instructions, not at the loads: with the
// loads prefetched, 6 or 7 resident blocks an SM run within 1%.
//
// Design: a 256-thread block owns one 512-doc block for every query of
// the launch (b_pad <= 256), so the stream is read once per launch.  A
// block first builds in shared memory the queries grouped by the union
// slot of their first term (a CSR list, in query order), a 64-bit
// filter of their second slots per first slot, and each query's later
// slots and slop.  Its 8 warps take the block's docs 16 at a time from
// a shared counter; per-doc row offsets (doc_row, each doc's first raw
// row inside its block) let a warp walk whole docs.  Raw row r of block
// j lives at pack index (offs[j] + r / (BM_CHUNK - KGAP)) * BM_CHUNK +
// r % (BM_CHUNK - KGAP), so the chunked, overlapped pack is read as it
// is, each row once.  A warp takes a doc 64 anchor rows at a time (a
// step), with the KGAP rows after them; cp.async copies the next step's
// rows into the warp's other buffer while this one is matched, so the
// row loads overlap the work.  Each row maps to its union slot once
// (slot_of stays a global read: the field's term table, L1/L2 resident).
// An anchor opens its queries only when a slot of its next 1 + slop rows
// passes their second-slot filter (a superset test: no match is lost),
// and the step's (anchor, query) pairs spread evenly over the lanes (one
// warp prefix sum of the anchors' counts, a binary search per pair), so
// a head term's 200 queries cost 7 rounds, not 200.  A pair matches
// when each later slot j holds its term in one of the rows anchor + j ..
// anchor + j + slop (dead slots, -1, always match): the oracle's phrase
// tf, each anchor once.  The kernel is built for smax 0, 1 and 2, so
// the window loops unroll.  Matches count in the warp's own int32 tf row
// [b_pad] (shared atomics: two anchors of a doc may match one query),
// and the queries a doc touched go on a list.  At the doc's end each
// touched query's score wp * (tf / (tf + cv)) (IEEE f32, no
// contraction) and class fold into the block's [FINE][b_pad] table as
// one 64-bit key, (order-preserving bits of the score) << 32 | class,
// with a shared atomicMax: max is order-free, so the result is the max
// score and the max class among the docs at it, the same bits on every
// run, whatever the sign of wp.  No [512][queries] tf tile exists, and
// nothing is zeroed per doc but the entries it touched.  Shared memory
// is about 32 KB a block and registers are held to 40 a thread, so 6
// blocks (48 warps) share an SM.  Empty and padded blocks write -inf
// and -1 and return.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define BM_BLOCK_DOCS 512
#define BM_CHUNK 2048
#define KGAP 8
#define USABLE (BM_CHUNK - KGAP)
#define KMAX 8
#define TID_BITS 22
#define TID_MASK ((1 << TID_BITS) - 1)
#define U_MAX 512
#define MAX_B 256
#define FINE 2
#define FINE_DOCS (BM_BLOCK_DOCS / FINE)
#define NT 256
#define NWARP (NT / 32)
#define GRAB 16  // docs a warp takes from its block at a time
#define STEP 64  // anchor rows a warp takes at a time
#define WIN (STEP + KGAP)
#define FULL 0xffffffffu

struct PhraseSmem {
  unsigned long long best[FINE * MAX_B];  // order key << 32 | class; 0: none
  unsigned long long second[U_MAX];       // by first slot: bit s1 & 63 of
                                          // its queries' second slots
  int tf[NWARP][MAX_B];                   // each warp's current doc
  int stage[NWARP][2][WIN];               // rows of a step, then their slots
  int slot_oc[U_MAX];                     // by first slot: its queries'
                                          // offset in q_list | count << 16
  short q_off[U_MAX + 1];                 // CSR offsets by first-term slot
  short pre[NWARP][STEP];                 // a step's inclusive pair counts
  short qt[MAX_B * KMAX];                 // union slot of term j, -1 dead
  int n_touched[NWARP];
  int next_doc;
  unsigned char q_list[MAX_B];            // queries by first-term slot
  unsigned char rank[MAX_B];              // a query's place in its slot
  unsigned char qs[MAX_B];                // slop
  unsigned char touched[NWARP][MAX_B];    // queries the warp's doc matched
};

// a warp's unit of work: the anchor rows [r0, min(r0 + STEP, re - KGAP))
// of block-local doc d, whose rows end at re; d < 0: none
struct Step {
  int r0, re, d;
};

// f32 bits -> u32 of the same order (block_scorer.cu's order_key)
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// union slot of a packed row
__device__ __forceinline__ int row_slot(int v, const int* __restrict__ slot_of,
                                        int n_terms) {
  const int t = v & TID_MASK;
  const int s = t < n_terms ? __ldg(slot_of + t) : -1;
  return (s >= 0 && s < U_MAX) ? s : -1;
}

// The number of queries the anchor at row a of the step (slot s) opens:
// those whose first slot is s, or 0 unless a slot of the rows a + 1 ..
// a + 1 + SMAX is in the filter of their second slots (a superset test:
// no match is ever dropped).
template <int SMAX>
__device__ __forceinline__ int anchor_queries(const PhraseSmem& sm,
                                              const int* w, int a, int s) {
  if (s < 0) return 0;
  const int n = sm.slot_oc[s] >> 16;
  if (!n) return 0;
  const unsigned long long m = sm.second[s];
  bool hit = false;
#pragma unroll
  for (int o = 1; o <= 1 + SMAX; ++o) {
    const int v = w[a + o];
    hit |= v >= 0 && ((m >> (v & 63)) & 1ull);
  }
  return hit ? n : 0;
}

// The warp's next grab of GRAB docs (false once the block is done): bnd
// holds doc d0 + lane's first row (lanes 0..GRAB), has a bit per doc
// with anchor rows.
__device__ __forceinline__ bool grab(PhraseSmem& sm, const int* dr, int lane,
                                     int& d0, int& bnd, unsigned& has) {
  int d = 0;
  if (lane == 0) d = atomicAdd(&sm.next_doc, GRAB);
  d0 = __shfl_sync(FULL, d, 0);
  if (d0 >= BM_BLOCK_DOCS) {
    has = 0u;
    return false;
  }
  bnd = lane <= GRAB ? dr[d0 + lane] : 0;
  const int end = __shfl_down_sync(FULL, bnd, 1);
  has = __ballot_sync(FULL, lane < GRAB && end - KGAP > bnd);
  return true;
}

// the step after one of grab index i (-1: the first), taking new grabs
// as needed
__device__ __forceinline__ Step next_doc_step(PhraseSmem& sm, const int* dr,
                                              int lane, int i, int& d0,
                                              int& bnd, unsigned& has) {
  unsigned m = i < 0 ? has : has & (0xfffffffeu << i);
  while (!m) {
    if (!grab(sm, dr, lane, d0, bnd, has)) return Step{0, 0, -1};
    m = has;
  }
  const int k = __ffs(m) - 1;
  return Step{__shfl_sync(FULL, bnd, k), __shfl_sync(FULL, bnd, k + 1),
              d0 + k};
}

// cp.async the rows of step st into buf (rows past the doc: sentinels)
__device__ __forceinline__ void prefetch_step(const Step& st, int* buf,
                                              int lane, int c0,
                                              const int* __restrict__ tok,
                                              long long n_tok) {
  if (st.d >= 0) {
#pragma unroll
    for (int k = lane; k < WIN; k += 32) {
      const int x = st.r0 + k;
      const long long idx =
          (long long)(c0 + x / USABLE) * BM_CHUNK + x % USABLE;
      if (x < st.re && idx < n_tok) {
        cp_async4(buf + k, tok + idx);
      } else {
        buf[k] = TID_MASK;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int SMAX>
__global__ void __launch_bounds__(NT, 6) phrase_kernel(
    const int* __restrict__ offs,       // [nb_pad + 1] chunk offsets
    const int* __restrict__ doc_row,    // [nb_pad, 513] raw row of each doc
    const int* __restrict__ tok,        // [n_tok] doc_local << 22 | tid
    long long n_tok,
    const float* __restrict__ cv,       // [nb_pad * 1024] BM25 denominator
    const int* __restrict__ fid,        // [nb_pad * 1024] fieldnorm ids
    const int* __restrict__ qterm,      // [b_pad, kmax] union slots, -1 dead
    int kmax,
    const int* __restrict__ qslop,      // [b_pad] slop, clamped to SMAX
    const float* __restrict__ wp,       // [b_pad] phrase weight
    const int* __restrict__ slot_of,    // [n_terms] union slot, -1
    int n_terms, int b_pad,
    float* __restrict__ amax,           // [nb_pad, FINE, b_pad]
    int* __restrict__ acls) {           // [nb_pad, FINE, b_pad]
  __shared__ PhraseSmem sm;
  const int j = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* dr = doc_row + (size_t)j * (BM_BLOCK_DOCS + 1);
  const size_t out0 = (size_t)j * FINE * b_pad;
  if (dr[0] == dr[BM_BLOCK_DOCS]) {  // no rows: nothing matches
    for (int p = threadIdx.x; p < FINE * b_pad; p += NT) {
      amax[out0 + p] = -CUDART_INF_F;
      acls[out0 + p] = -1;
    }
    return;
  }

  for (int p = threadIdx.x; p <= U_MAX; p += NT) sm.q_off[p] = 0;
  for (int p = threadIdx.x; p < U_MAX; p += NT) sm.second[p] = 0ull;
  for (int p = threadIdx.x; p < FINE * b_pad; p += NT) sm.best[p] = 0ull;
  for (int p = threadIdx.x; p < NWARP * MAX_B; p += NT) (&sm.tf[0][0])[p] = 0;
  for (int p = threadIdx.x; p < b_pad * KMAX; p += NT) {
    const int q = p / KMAX, jj = p % KMAX;
    const int v = jj < kmax ? qterm[(size_t)q * kmax + jj] : -1;
    sm.qt[p] = (short)(v < 0 ? -1 : min(v, U_MAX));  // U_MAX: no row's slot
  }
  for (int q = threadIdx.x; q < b_pad; q += NT) {
    sm.qs[q] = (unsigned char)min(max(qslop[q], 0), SMAX);
  }
  if (lane == 0) sm.n_touched[warp] = 0;
  if (threadIdx.x == 0) sm.next_doc = 0;
  __syncthreads();

  if (warp == 0) {
    // count the queries of each first-term slot into q_off[s + 1] and
    // rank each query inside its slot, in query order
    for (int c = 0; c < b_pad; c += 32) {
      const int q = c + lane;
      int s = q < b_pad ? sm.qt[q * KMAX] : -1;
      if (s >= U_MAX) s = -1;
      const unsigned peers = __match_any_sync(FULL, s);
      const int base = s >= 0 ? sm.q_off[s + 1] : 0;
      if (q < b_pad) sm.rank[q] = (unsigned char)(base + __popc(peers & ((1u << lane) - 1)));
      __syncwarp();
      if (s >= 0 && lane == __ffs(peers) - 1) sm.q_off[s + 1] = (short)(base + __popc(peers));
      __syncwarp();
    }
    // inclusive prefix over q_off[1..U_MAX]: q_off[s] is the first entry
    // of slot s in q_list
    const int per = U_MAX / 32;
    int sum = 0;
    for (int i = 1; i <= per; ++i) sum += sm.q_off[per * lane + i];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
    for (int i = 1; i <= per; ++i) {
      run += sm.q_off[per * lane + i];
      sm.q_off[per * lane + i] = (short)run;
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < U_MAX; s += NT) {
    sm.slot_oc[s] = sm.q_off[s] | (sm.q_off[s + 1] - sm.q_off[s]) << 16;
  }
  for (int q = threadIdx.x; q < b_pad; q += NT) {
    const int s = sm.qt[q * KMAX];
    if (s >= 0 && s < U_MAX) {
      sm.q_list[sm.q_off[s] + sm.rank[q]] = (unsigned char)q;
      const int s1 = kmax > 1 ? sm.qt[q * KMAX + 1] : -1;  // -1: dead
      atomicOr(&sm.second[s], s1 < 0 ? ~0ull : 1ull << (s1 & 63));
    }
  }
  __syncthreads();

  const int c0 = offs[j];
  const size_t doc0 = (size_t)j * 1024;
  int* tf = sm.tf[warp];
  short* pre = sm.pre[warp];
  unsigned char* touched = sm.touched[warp];
  int d0 = 0, bnd = 0;
  unsigned has = 0u;
  Step cur = next_doc_step(sm, dr, lane, -1, d0, bnd, has);
  prefetch_step(cur, sm.stage[warp][0], lane, c0, tok, n_tok);
  int b = 0;
  while (cur.d >= 0) {
    // the next step's rows load while this one is matched
    Step nxt = cur;
    nxt.r0 += STEP;
    if (nxt.r0 >= cur.re - KGAP) {
      nxt = next_doc_step(sm, dr, lane, cur.d - d0, d0, bnd, has);
    }
    prefetch_step(nxt, sm.stage[warp][b ^ 1], lane, c0, tok, n_tok);
    asm volatile("cp.async.wait_group 1;\n" ::);
    int* w = sm.stage[warp][b];
    const int last = cur.re - KGAP;  // anchors: the doc's positions
    const int va = w[lane], vb = w[32 + lane];
    const int vc = lane < KGAP ? w[64 + lane] : TID_MASK;
    const int sa = row_slot(va, slot_of, n_terms);
    const int sb = row_slot(vb, slot_of, n_terms);
    const int sc = row_slot(vc, slot_of, n_terms);
    w[lane] = sa;
    w[32 + lane] = sb;
    if (lane < KGAP) w[64 + lane] = sc;
    __syncwarp();
    const int na = cur.r0 + lane < last ? anchor_queries<SMAX>(sm, w, lane, sa) : 0;
    const int nb =
        cur.r0 + 32 + lane < last ? anchor_queries<SMAX>(sm, w, 32 + lane, sb) : 0;
    // one scan of both rows' counts, packed (a step opens < 2^16 pairs)
    int inc = na | nb << 16;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += y;
    }
    const int tot = __shfl_sync(FULL, inc, 31);
    pre[lane] = (short)(inc & 0xffff);
    pre[32 + lane] = (short)((tot & 0xffff) + (inc >> 16));
    const int total = (tot & 0xffff) + (tot >> 16);
    __syncwarp();
    for (int p = lane; p < total; p += 32) {
      int a = 0;  // the pair's anchor: the first row with pre > p
#pragma unroll
      for (int step = STEP / 2; step; step >>= 1) {
        if (pre[a + step - 1] <= p) a += step;
      }
      const int q =
          sm.q_list[(sm.slot_oc[w[a]] & 0xffff) + p - (a ? pre[a - 1] : 0)];
      const short* qq = sm.qt + q * KMAX;
      const int sl = sm.qs[q];
      bool ok = true;
      for (int jj = 1; jj < kmax && ok; ++jj) {
        const int want = qq[jj];
        if (want < 0) continue;
        bool hit = false;
#pragma unroll
        for (int ss = 0; ss <= SMAX; ++ss) hit |= ss <= sl && w[a + jj + ss] == want;
        ok = hit;
      }
      if (ok && atomicAdd(&tf[q], 1) == 0) {
        touched[atomicAdd(&sm.n_touched[warp], 1)] = (unsigned char)q;
      }
    }
    __syncwarp();  // this buffer is refilled two steps on
    const int nt = sm.n_touched[warp];
    if (nt && nxt.d != cur.d) {  // fold the finished doc into the table
      const float c = cv[doc0 + cur.d];
      const int fi = fid[doc0 + cur.d];
      unsigned long long* best = sm.best + (cur.d / FINE_DOCS) * b_pad;
      for (int k = lane; k < nt; k += 32) {
        const int q = touched[k];
        const int t = tf[q];
        tf[q] = 0;
        const float tff = (float)t;
        const float scr =
            __fmul_rn(__ldg(wp + q), __fdiv_rn(tff, __fadd_rn(tff, c)));
        atomicMax(best + q, ((unsigned long long)order_key(scr) << 32) |
                                (unsigned)(t * 256 + (255 - fi)));
      }
      __syncwarp();
      if (lane == 0) sm.n_touched[warp] = 0;
      __syncwarp();
    }
    cur = nxt;
    b ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  for (int p = threadIdx.x; p < FINE * b_pad; p += NT) {
    const unsigned long long key = sm.best[p];
    amax[out0 + p] = key ? key_float((unsigned)(key >> 32)) : -CUDART_INF_F;
    acls[out0 + p] = key ? (int)(unsigned)key : -1;
  }
}

// the largest registers a thread and static shared bytes a block, and the
// fewest resident blocks per SM, of the kernel's instantiations
extern "C" int fugu_phrase_info(int* regs, int* smem, int* per_sm) {
  const void* fns[] = {(const void*)phrase_kernel<0>,
                       (const void*)phrase_kernel<1>,
                       (const void*)phrase_kernel<2>};
  *regs = 0;
  *smem = 0;
  *per_sm = 1 << 30;
  for (const void* fn : fns) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, NT, 0);
    if (err != cudaSuccess) return (int)err;
    *regs = max(*regs, attr.numRegs);
    *smem = max(*smem, (int)attr.sharedSizeBytes);
    *per_sm = min(*per_sm, n);
  }
  return (int)cudaSuccess;
}

extern "C" int fugu_phrase(
    const int* offs, const int* doc_row, int nb_pad, const int* tok,
    long long n_tok, const float* cv, const int* fid, const int* qterm,
    int kmax, const int* qslop, int smax, const float* wp,
    const int* slot_of, int n_terms, int b_pad, float* amax, int* acls,
    void* stream) {
  if (b_pad < 1 || b_pad > MAX_B || kmax < 1 || kmax > KMAX || smax < 0 ||
      smax > 2 || kmax - 1 + smax > KGAP || n_terms < 1 || nb_pad < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (nb_pad > 0) {
    cudaStream_t st = (cudaStream_t)stream;
#define FUGU_PHRASE_LAUNCH(S)                                             \
  phrase_kernel<S><<<nb_pad, NT, 0, st>>>(offs, doc_row, tok, n_tok, cv,   \
                                          fid, qterm, kmax, qslop, wp,     \
                                          slot_of, n_terms, b_pad, amax,   \
                                          acls)
    if (smax == 0) {
      FUGU_PHRASE_LAUNCH(0);
    } else if (smax == 1) {
      FUGU_PHRASE_LAUNCH(1);
    } else {
      FUGU_PHRASE_LAUNCH(2);
    }
#undef FUGU_PHRASE_LAUNCH
  }
  return (int)cudaGetLastError();
}
