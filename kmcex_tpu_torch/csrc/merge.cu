// Merge of two ascending (64-bit key, 32-bit payload) runs on Hopper.
//
// Replaces the TPU sorted-run merge of kmcex_tpu/count/sort_pallas.py
// merge_sorted_u64 (:387-412): the final bitonic stage over a ++ reversed b,
// run by
//   K2 _hbm_step_kernel with asc_override (sort_pallas.py:218-296,
//      pallas_call :266) when the runs span several blocks, and
//   K3 _bitonic_finish_kernel (sort_pallas.py:415-445, pallas_call :434)
//      when both fit in one block.
// Contract kept: the output is the ascending merge of both runs, of length
// la + lb, each payload with its key, for any run lengths — SENTINEL-padded
// runs included (SENTINEL is the largest unsigned key, so padding merges to
// the tail).  No power-of-two padding is needed.
//
// Design: merge path.  Thread t owns output slots [t*ITEMS, (t+1)*ITEMS):
// it binary-searches its diagonal for the split (i, j) with i + j =
// t*ITEMS, then merges ITEMS outputs sequentially.  Ties take a first.
//
// What bounds it on an H100: device-memory traffic, ideally one read of each
// run and one write of the output (24 bytes per element with payloads).  The
// per-thread sequential reads are strided by ITEMS across a warp, so loads
// are only partly coalesced; staging each block's two input windows in
// shared memory first is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

namespace {

constexpr int ITEMS = 8;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    merge_path(const u64* a, const u32* ca, long long la, const u64* b,
               const u32* cb, long long lb, u64* ok, u32* oc) {
  const long long total = la + lb;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long diag = t * ITEMS;
  if (diag >= total) return;
  // smallest i such that a[i] > b[diag - i - 1]: the number of a-elements
  // among the first diag outputs (a wins ties)
  long long lo = diag > lb ? diag - lb : 0;
  long long hi = diag < la ? diag : la;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (a[mid] <= b[diag - mid - 1])
      lo = mid + 1;
    else
      hi = mid;
  }
  long long i = lo, j = diag - lo;
  const long long end = diag + ITEMS < total ? diag + ITEMS : total;
  for (long long o = diag; o < end; ++o) {
    bool take_a = i < la && (j >= lb || a[i] <= b[j]);
    if (take_a) {
      ok[o] = a[i];
      oc[o] = ca[i];
      ++i;
    } else {
      ok[o] = b[j];
      oc[o] = cb[j];
      ++j;
    }
  }
}

}  // namespace

extern "C" int kx_merge_u64(const void* a, const void* ca, long long la,
                            const void* b, const void* cb, long long lb,
                            void* out_k, void* out_c, void* stream) {
  const long long total = la + lb;
  if (total <= 0) return 0;
  const long long threads = (total + ITEMS - 1) / ITEMS;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  merge_path<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const u64*)a, (const u32*)ca, la, (const u64*)b, (const u32*)cb, lb,
      (u64*)out_k, (u32*)out_c);
  return (int)cudaGetLastError();
}
