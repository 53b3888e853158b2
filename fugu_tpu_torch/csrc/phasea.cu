// Phase A of the two-phase batch engine: one stream over the
// block-major pack that gives every query of a batch its maximum
// (gated) score in each fine slice of each 512-doc block.
//
// Replaces the TPU kernel fugu_tpu/ops/batch_scorer.py::_phasea_kernel
// (wrapper phasea_callable).
//
// What bounds it on an H100: the scatter-accumulate.  The pack is read
// once per query-lane tile (10 bytes an entry: doc, term id, bf16
// contribution), but every entry whose term is in the batch's union
// adds into up to 64 query lanes of its doc, which makes the
// shared-memory atomics, not device memory, the limit.
//
// Design: the grid is (query-lane tile) x (512-doc block).  A thread
// block keeps its tile of the per-doc sums S[512][QT] in shared memory
// (128 KB: 64 score lanes, or 32 score and 32 count lanes in the wide
// and packed modes), which the 227 KB a block may use holds where the
// TPU's [512, 2B] tile would not.  The TPU kernel's [C, U] one-hot term
// compare becomes a gather through a term -> union-slot table that the
// host builds for each stream, and its one-hot doc matmul becomes
// shared-memory float atomics.  A warp loads 32 entries, keeps those
// whose term is in the union, and broadcasts them one at a time; each
// lane then adds into its own query lanes, so a warp's atomics hit
// consecutive addresses.  Zero weights (a query without the term) are
// skipped.  Sums are f32 throughout (the TPU rounds each product to
// bf16); count lanes hold small integers and stay exact, also when two
// queries share a lane as lo + 4096 * hi.  The gate and the per-slice
// max run over the tile after the stream; docs with no accepted entry
// and padded blocks come out as -inf.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define BM_BLOCK_DOCS 512
#define BM_CHUNK 2048
#define NT 512
#define PACK_FIELD 4096.0f

__device__ __forceinline__ float bf16_to_f32(unsigned short v) {
  return __uint_as_float(((unsigned)v) << 16);
}

// mode: 0 narrow (lanes == b_pad), 1 wide (2 * b_pad), 2 packed (1.5 * b_pad)
__global__ void __launch_bounds__(NT) phasea_kernel(
    const int* __restrict__ offs,              // [nb + 1] chunk offsets
    const int* __restrict__ doc,               // [E] global doc id, -1 pad
    const int* __restrict__ tid,               // [E] global term id, -1 pad
    const unsigned short* __restrict__ con,    // [E] bf16 contribution
    const unsigned short* __restrict__ w,      // [U, lanes] bf16 weights
    int lanes,
    const int* __restrict__ slot_of,           // [n_terms] union slot, -1
    int n_terms,
    const float* __restrict__ nm,              // [b_pad] threshold / count
    int b_pad, int mode, int qt, int fine,
    float* __restrict__ out) {                 // [nb, fine, b_pad]
  extern __shared__ float smem[];
  float* S = smem;                              // [512][qt] scores
  float* C = smem + BM_BLOCK_DOCS * qt;         // [512][qt] counts
  const int q0 = blockIdx.x * qt;
  const int j = blockIdx.y;
  const int base = j * BM_BLOCK_DOCS;
  const int half = b_pad / 2;
  const int n_acc = (mode == 0 ? 1 : 2) * BM_BLOCK_DOCS * qt;

  for (int i = threadIdx.x; i < n_acc; i += NT) smem[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long e0 = (long)offs[j] * BM_CHUNK;
  const long e1 = (long)offs[j + 1] * BM_CHUNK;
  for (long e = e0 + (long)warp * 32; e < e1; e += (NT / 32) * 32) {
    const long idx = e + lane;
    int slot = -1, loc = 0;
    float cv = 0.f;
    if (idx < e1) {
      const int t = tid[idx];
      if (t >= 0 && t < n_terms) slot = slot_of[t];
      if (slot >= 0) {
        loc = doc[idx] - base;
        cv = bf16_to_f32(con[idx]);
        if ((unsigned)loc >= BM_BLOCK_DOCS) slot = -1;
      }
    }
    unsigned live = __ballot_sync(0xffffffffu, slot >= 0);
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const int s = __shfl_sync(0xffffffffu, slot, src);
      const int l = __shfl_sync(0xffffffffu, loc, src);
      const float c = __shfl_sync(0xffffffffu, cv, src);
      const unsigned short* wrow = w + (size_t)s * lanes;
      for (int q = lane; q < qt; q += 32) {
        const int gq = q0 + q;
        const float ws = bf16_to_f32(wrow[gq]);
        if (ws != 0.f) atomicAdd(&S[l * qt + q], ws * c);
        if (mode != 0) {
          const int cl = b_pad + (mode == 1 ? gq : gq % half);
          const float wc = bf16_to_f32(wrow[cl]);
          if (wc != 0.f) atomicAdd(&C[l * qt + q], wc);
        }
      }
    }
  }
  __syncthreads();

  const int per = BM_BLOCK_DOCS / fine;
  for (int p = threadIdx.x; p < qt * fine; p += NT) {
    const int q = p % qt;
    const int f = p / qt;
    const int gq = q0 + q;
    const float thr = nm[gq];
    float best = -CUDART_INF_F;
    for (int d = f * per; d < (f + 1) * per; ++d) {
      const float s = S[d * qt + q];
      bool ok;
      if (mode == 0) {
        ok = s > thr;  // narrow: per-query score threshold
      } else {
        float cnt = C[d * qt + q];
        if (mode == 2) {
          const float hi = rintf(cnt * (1.0f / PACK_FIELD));
          const float lo = cnt - hi * PACK_FIELD;
          cnt = gq < half ? lo : hi;
        }
        ok = s > 0.f && cnt > thr - 0.5f;  // wide: required count
      }
      if (ok) best = fmaxf(best, s);
    }
    out[((size_t)j * fine + f) * b_pad + gq] = best;
  }
}

extern "C" int fugu_phasea_smem_bytes(int mode, int qt) {
  return (mode == 0 ? 1 : 2) * BM_BLOCK_DOCS * qt * (int)sizeof(float);
}

extern "C" int fugu_phasea(
    const int* offs, int nb, const int* doc, const int* tid,
    const unsigned short* con, const unsigned short* w, int lanes,
    const int* slot_of, int n_terms, const float* nm, int b_pad, int mode,
    int qt, int fine, float* out, void* stream) {
  const int smem = fugu_phasea_smem_bytes(mode, qt);
  cudaError_t err = cudaFuncSetAttribute(
      phasea_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (nb > 0) {
    dim3 grid(b_pad / qt, nb);
    phasea_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
        offs, doc, tid, con, w, lanes, slot_of, n_terms, nm, b_pad, mode, qt,
        fine, out);
  }
  return (int)cudaGetLastError();
}
