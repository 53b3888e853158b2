// Phase A of the two-phase batch engine: one stream over the
// block-major pack that gives every query of a batch its maximum
// (gated) score in each fine slice of each 512-doc block.
//
// Replaces the TPU kernel fugu_tpu/ops/batch_scorer.py::_phasea_kernel
// (fugu_tpu/ops/batch_scorer.py:195, wrapper phasea_callable at :338).
//
// What bounds it on an H100: device memory.  The pack is read once per
// stream, 10 bytes a real entry (doc, term id, bf16 contribution): about
// 0.43 GB, 0.13 ms at 3.35 TB/s, for a 1M-doc segment.  The arithmetic
// is small beside it: a query uses 1 to 16 of the batch's hundreds of
// union terms, so the weight matrix W [U, lanes] is ~99% zeros and its
// nonzero products number far fewer than the entries.
//
// Design: persistent thread blocks of 8 warps walk the 512-doc blocks.
// Each warp owns 64 consecutive docs of a block, whose entries form one
// run because the pack is doc-major inside each block (doc_offs says
// where each doc starts).  A thread block first copies W's nonzeros,
// built on the host as per-slot lists of (lane | bf16 weight << 16),
// into shared memory, so no entry waits on a global load of W.  The warp
// streams its run 32 entries at a time, maps each entry's term to its
// union slot, and visits the live entries in pack order: the warp's
// threads split the slot's nonzero list and add w * con (count lanes:
// w) into the warp's own row of per-lane sums in shared memory.  A
// slot's list names each lane once, so no two threads touch one sum and
// no atomics are needed; each sum is taken in pack order with
// __fmul_rn / __fadd_rn, the order of the plain version's index_add_ on
// the CPU, and the same inputs give the same bits on every run.  When
// the doc changes, the warp gates the finished doc (score > threshold;
// wide and packed modes: score > 0 and count >= need) into per-query
// running maxima held in registers and clears its row.  A warp's 64 docs
// lie in one fine slice (fine <= 8), so a slice's maximum is the max
// over its warps.  Docs without a live entry cost only their reads, and
// blocks without entries come out as -inf.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define BM_BLOCK_DOCS 512
#define NT 256
#define NWARP (NT / 32)
#define WARP_DOCS (BM_BLOCK_DOCS / NWARP)
#define MAX_B 256
#define QPL (MAX_B / 32)  // queries per thread of a warp
#define PACK_FIELD 4096.0f
#define FULL 0xffffffffu

__device__ __forceinline__ float bf16_to_f32(unsigned short v) {
  return __uint_as_float(((unsigned)v) << 16);
}

// Gates the warp's finished doc (its sums in ``row``) into the running
// maxima of the thread's queries lane, lane + 32, ... and clears the row.
// mode: 0 narrow (lanes == b), 1 wide (2b), 2 packed (1.5b).
__device__ __forceinline__ void fold_doc(float* row, float (&best)[QPL],
                                         const float (&thr)[QPL], int b,
                                         int lanes, int mode, int lane) {
  const int half = b / 2;
#pragma unroll
  for (int i = 0; i < QPL; ++i) {
    const int q = lane + 32 * i;
    if (q < b) {
      const float s = row[q];
      bool ok;
      if (mode == 0) {
        ok = s > thr[i];  // narrow: per-query score threshold
      } else {
        float cnt = row[b + (mode == 1 ? q : q % half)];
        if (mode == 2) {
          const float hi = rintf(cnt * (1.0f / PACK_FIELD));
          const float lo = cnt - hi * PACK_FIELD;
          cnt = q < half ? lo : hi;
        }
        ok = s > 0.f && cnt > thr[i] - 0.5f;  // wide: required count
      }
      if (ok) best[i] = fmaxf(best[i], s);
    }
  }
  __syncwarp();
  for (int q = lane; q < lanes; q += 32) row[q] = 0.f;
  __syncwarp();
}

__global__ void __launch_bounds__(NT) phasea_kernel(
    const int* __restrict__ doc_offs,        // [nb, 513] doc starts
    int nb,
    const int* __restrict__ doc,             // [E] global doc id
    const int* __restrict__ tid,             // [E] global term id, -1 pad
    const unsigned short* __restrict__ con,  // [E] bf16 contribution
    const int* __restrict__ nz_off,          // [n_slots + 1]
    const int* __restrict__ nz,              // [nnz] lane | bf16 << 16
    int n_slots, int nnz,
    const int* __restrict__ slot_of,         // [n_terms] union slot, -1
    int n_terms,
    const float* __restrict__ nm,            // [b] threshold / count
    int b, int lanes, int mode, int fine,
    float* __restrict__ out) {               // [nb, fine, b]
  extern __shared__ __align__(16) int smem[];
  int* s_off = smem;                            // [n_slots + 1]
  int* s_nz = s_off + n_slots + 1;              // [nnz]
  float* rows = (float*)(s_nz + nnz);           // [NWARP][lanes] sums
  float* wmax = rows + NWARP * lanes;           // [NWARP][b] maxima

  for (int i = threadIdx.x; i <= n_slots; i += NT) s_off[i] = nz_off[i];
  for (int i = threadIdx.x; i < nnz; i += NT) s_nz[i] = nz[i];
  for (int i = threadIdx.x; i < NWARP * lanes; i += NT) rows[i] = 0.f;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* row = rows + warp * lanes;
  float thr[QPL];
#pragma unroll
  for (int i = 0; i < QPL; ++i) {
    const int q = lane + 32 * i;
    thr[i] = q < b ? nm[q] : 0.f;
  }
  __syncthreads();

  const int wpf = BM_BLOCK_DOCS / fine / WARP_DOCS;  // warps per slice
  for (int j = blockIdx.x; j < nb; j += gridDim.x) {
    float best[QPL];
#pragma unroll
    for (int i = 0; i < QPL; ++i) best[i] = -CUDART_INF_F;
    const int* dof =
        doc_offs + (size_t)j * (BM_BLOCK_DOCS + 1) + warp * WARP_DOCS;
    const int eb = dof[0];
    const int ee = dof[WARP_DOCS];
    int cur = -1;  // the doc whose sums the row holds
    for (int e = eb; e < ee; e += 32) {
      const int idx = e + lane;
      int slot = -1, d = 0;
      float c = 0.f;
      if (idx < ee) {
        const int t = tid[idx];
        d = doc[idx];
        c = bf16_to_f32(con[idx]);
        if ((unsigned)t < (unsigned)n_terms) slot = slot_of[t];
        if (slot >= n_slots) slot = -1;
      }
      unsigned live = __ballot_sync(FULL, slot >= 0);
      while (live) {
        const int src = __ffs(live) - 1;
        live &= live - 1;
        const int s = __shfl_sync(FULL, slot, src);
        const int dd = __shfl_sync(FULL, d, src);
        const float cc = __shfl_sync(FULL, c, src);
        if (dd != cur) {  // uniform across the warp
          if (cur >= 0) fold_doc(row, best, thr, b, lanes, mode, lane);
          cur = dd;
        }
        const int p1 = s_off[s + 1];
        for (int p = s_off[s] + lane; p < p1; p += 32) {
          const unsigned v = (unsigned)s_nz[p];
          const int q = (int)(v & 0xffffu);
          const float w = __uint_as_float(v & 0xffff0000u);
          row[q] = __fadd_rn(row[q], q < b ? __fmul_rn(w, cc) : w);
        }
        __syncwarp();
      }
    }
    if (cur >= 0) fold_doc(row, best, thr, b, lanes, mode, lane);

#pragma unroll
    for (int i = 0; i < QPL; ++i) {
      const int q = lane + 32 * i;
      if (q < b) wmax[warp * b + q] = best[i];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < fine * b; p += NT) {
      const int f = p / b;
      const int q = p % b;
      float m = -CUDART_INF_F;
      for (int w = f * wpf; w < (f + 1) * wpf; ++w) m = fmaxf(m, wmax[w * b + q]);
      out[((size_t)j * fine + f) * b + q] = m;
    }
    __syncthreads();  // wmax is rewritten for the next block
  }
}

extern "C" int fugu_phasea_smem_bytes(int n_slots, int nnz, int lanes, int b) {
  return (n_slots + 1 + nnz + NWARP * lanes + NWARP * b) * (int)sizeof(int);
}

extern "C" int fugu_phasea(
    const int* doc_offs, int nb, const int* doc, const int* tid,
    const unsigned short* con, const int* nz_off, const int* nz, int n_slots,
    int nnz, const int* slot_of, int n_terms, const float* nm, int b,
    int lanes, int mode, int fine, float* out, void* stream) {
  if (b <= 0 || b > MAX_B || b % 32 || mode < 0 || mode > 2 ||
      (fine != 1 && fine != 2 && fine != 4 && fine != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = fugu_phasea_smem_bytes(n_slots, nnz, lanes, b);
  cudaError_t err = cudaFuncSetAttribute(
      phasea_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, phasea_kernel,
                                                      NT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = nb < sms * per_sm ? nb : sms * per_sm;
  phasea_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      doc_offs, nb, doc, tid, con, nz_off, nz, n_slots, nnz, slot_of, n_terms,
      nm, b, lanes, mode, fine, out);
  return (int)cudaGetLastError();
}
