// What the card holds of each kernel instantiation, for the kernel verifier
// (analysis/kernel_rules.py, rule K3): each source file lists its own
// instantiations through the same switches its launch takes, and
// kernel_attributes.cu numbers them behind one C entry,
// repro_kernel_attributes.
#pragma once
#include <cuda_runtime.h>

namespace kernel_attributes {

// Ints a record holds: the instantiation's key (kernel id, then up to three
// template arguments), then cudaFuncGetAttributes' registers, local bytes,
// static shared bytes, maximum dynamic shared bytes and maximum threads a
// block, then the launch's threads, dynamic shared bytes and the
// __launch_bounds__ minimum of blocks an SM (1 where none is declared), and
// the blocks an SM the occupancy calculator holds at that launch.
constexpr int FIELDS = 13;

// Kernel ids of the key, in the order of repro_kernel_attributes' records.
enum Kernel { BANK_MXV_POP = 0, BANK_QMM_POP = 1, QUANT_MATMUL = 2,
              SRU_SCAN_POP = 3 };

// Fills out[0 .. FIELDS) for kernel K launched with `threads` threads and
// `smem` bytes of dynamic shared memory (which the caller has allowed).
template <class K>
inline cudaError_t fill(K kernel, int id, int a, int b, int c, int threads,
                        int smem, int min_blocks, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  const int v[FIELDS] = {id,
                         a,
                         b,
                         c,
                         attr.numRegs,
                         static_cast<int>(attr.localSizeBytes),
                         static_cast<int>(attr.sharedSizeBytes),
                         attr.maxDynamicSharedSizeBytes,
                         attr.maxThreadsPerBlock,
                         threads,
                         smem,
                         min_blocks,
                         blocks};
  for (int i = 0; i < FIELDS; ++i) out[i] = v[i];
  return cudaSuccess;
}

// Each source's records, numbered from 0; cudaErrorInvalidValue past its
// last.
cudaError_t bank_mxv_pop(int i, int* out);
cudaError_t bank_qmm_pop(int i, int* out);
cudaError_t quant_matmul(int i, int* out);
cudaError_t sru_scan_pop(int i, int* out);

}  // namespace kernel_attributes
