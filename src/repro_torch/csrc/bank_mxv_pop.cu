// Population MxV against a quantized-weight bank: out[p] = x[p] @ bank[idx[p]].
//
// Replaces: the Pallas kernel src/repro/kernels/sru_scan.py::bank_mxv_pop
// (body _bank_mxv_kernel), which selects the bank row per grid step through
// a scalar-prefetched index in the BlockSpec index map.
//
// What bounds it on an H100: operations. At the main path's FC shape
// (P=16, M=1536, m=1100, N=1904) it does 103 GFLOP against ~330 MB of
// traffic (~310 flop/byte), so fp32 FMA on the CUDA cores (67 TFLOP/s, no
// TF32 by the parity rule) bounds it at ~1.54 ms.
//
// Design: the TPU kernel's scalar prefetch becomes a pointer offset. Each
// block reads its lane's menu index from device memory and reads the
// selected (m, N) bank row in place, so no (P, m, N) gathered copy ever
// exists. The GEMM itself is the shared SIMT tile in bank_gemm.cuh (64x64
// outputs per block, 16-deep K tiles in shared memory, 4x4 per thread):
// simple and exact first; wgmma/TMA tiles are later work.
#include <cuda_runtime.h>

#include "bank_gemm.cuh"

namespace {

struct BankRowLoader {
  const float* __restrict__ row;  // (m, N), the lane's selected bank row
  int N;
  __device__ __forceinline__ float operator()(int k, int c) const {
    return row[static_cast<long long>(k) * N + c];
  }
};

__global__ void __launch_bounds__(bank_gemm::THREADS)
    bank_mxv_pop_kernel(const float* __restrict__ x,
                        const float* __restrict__ bank,
                        const int* __restrict__ idx, float* __restrict__ out,
                        int M, int m, int N, int K) {
  const int p = blockIdx.z;
  const int sel = idx[p];
  float* lane_out = out + static_cast<long long>(p) * M * N;
  if (sel < 0 || sel >= K) {
    bank_gemm::poison_tile(lane_out, M, N);
    return;
  }
  const BankRowLoader load{bank + static_cast<long long>(sel) * m * N, N};
  bank_gemm::gemm_tile(x + static_cast<long long>(p) * M * m, lane_out, M, m,
                       N, load);
}

}  // namespace

// x: (P, M, m) f32; bank: (K, m, N) f32; idx: (P,) int32 on the device;
// out: (P, M, N) f32. All contiguous. Returns cudaGetLastError().
extern "C" int repro_bank_mxv_pop(const float* x, const float* bank,
                                  const int* idx, float* out, int P, int M,
                                  int m, int N, int K, void* stream) {
  bank_mxv_pop_kernel<<<bank_gemm::grid_for(P, M, N), bank_gemm::THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, bank, idx, out,
                                                             M, m, N, K);
  return static_cast<int>(cudaGetLastError());
}
