// Population MxV against a quantized-weight bank: out[p] = x[p] @ bank[idx[p]].
//
// Replaces: the Pallas kernel src/repro/kernels/sru_scan.py::bank_mxv_pop
// (body _bank_mxv_kernel), which selects the bank row per grid step through
// a scalar-prefetched index in the BlockSpec index map.
//
// What bounds it on an H100: operations at the search shapes, 2 P M m N
// flops in fp32 on the CUDA cores (67 TFLOP/s; no TF32 by the parity rule):
// FC (16, 1536, 1100) x (1100, 1904) 103 GFLOP, 1.54 ms; L (256 -> 1650)
// 0.31 ms; Pr (1100 -> 256) 0.21 ms. At the serving shapes (8 lanes of 16
// rows) it reads each selected bank row for a few hundred flops per weight,
// so bytes and the latency of the K loop bound it.
//
// Design: the TPU kernel's scalar prefetch becomes a pointer offset. Each
// block reads its lane's menu index from device memory and reads the
// selected (m, N) bank row in place, so no (P, m, N) gathered copy exists.
// The GEMM is bank_gemm.cuh's: a register tile of TM x 8 per thread, a
// cp.async ring for x and the bank row (the row's copy width W chosen by
// the wrapper from N and the bank's alignment), and a tile configuration
// chosen by shape (kernels/ops.py::bank_config): 128 x 128 or 128 x 64 for
// the search's 1536 rows per lane, 16 x 64 for the serving step.
#include <cuda_runtime.h>

#include "bank_gemm.cuh"
#include "checked.cuh"
#include "kernel_attributes.cuh"

namespace {

// The C entry's pointer parameters, in order (checked.cuh's extents).
enum Param { X, BANK, IDX, OUT };

template <class T, int W>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    bank_mxv_pop_kernel(const float* __restrict__ x,
                        const float* __restrict__ bank,
                        const int* __restrict__ idx, float* __restrict__ out,
                        int M, int m, int N, int K) {
  extern __shared__ float4 smem[];
  CK_SHARED_ARRAY(smem, T::SMEM);
  const int p = blockIdx.z;
  const int sel = CK_LD(IDX, idx + p);
  float* lane_out = out + static_cast<long long>(p) * M * N;
  if (sel < 0 || sel >= K) {
    bank_gemm::poison_tile<T, OUT>(lane_out, M, N);
    return;
  }
  // the lane's (m, N) bank row, read in place
  bank_gemm::BCopier<T, W, BANK> load(
      bank + static_cast<long long>(sel) * m * N, m, N,
      static_cast<int>(blockIdx.x) * T::BN);
  bank_gemm::gemm_tile<T, X, OUT>(x + static_cast<long long>(p) * M * m,
                                  lane_out, M, m, N, load,
                                  reinterpret_cast<float*>(smem));
}

}  // namespace

// x: (P, M, m) f32; bank: (K, m, N) f32; idx: (P,) int32 on the device;
// out: (P, M, N) f32. All contiguous. config: a bank_gemm configuration
// (0-2); width: the bank rows' cp.async width in bytes (16, 8 or 4),
// dividing N * 4 and the bank's alignment. Returns the CUDA error of the
// launch (or of raising its shared-memory limit).
extern "C" int repro_bank_mxv_pop(const float* x, const float* bank,
                                  const int* idx, float* out, int P, int M,
                                  int m, int N, int K, int config, int width,
                                  void* stream) {
  return static_cast<int>(bank_gemm::with_config(config, [&](auto cfg) {
    using T = decltype(cfg);
    return bank_gemm::with_width(width, [&](auto w) {
      constexpr int W = decltype(w)::value;
      const cudaError_t err =
          bank_gemm::allow_smem<bank_mxv_pop_kernel<T, W>, T::SMEM>();
      if (err != cudaSuccess) return err;
      bank_mxv_pop_kernel<T, W>
          <<<bank_gemm::grid_for<T>(P, M, N), T::THREADS, T::SMEM,
             static_cast<cudaStream_t>(stream)>>>(x, bank, idx, out, M, m, N,
                                                  K);
      return cudaGetLastError();
    });
  }));
}

// The numbers of bank_gemm configuration `config` into out[0..7]: BM, BN,
// BK, TM, STAGES, THREADS, MIN_BLOCKS, dynamic shared-memory bytes. Returns
// a CUDA error for an unknown configuration.
extern "C" int repro_bank_config_info(int config, int* out) {
  return static_cast<int>(bank_gemm::config_info(config, out));
}

// The records of kernel_attributes.cuh: configuration i / 3 at the copy
// widths 16, 8 and 4 bytes (with_width's cases), its launch's shared
// memory allowed first.
cudaError_t kernel_attributes::bank_mxv_pop(int i, int* out) {
  constexpr int widths[3] = {16, 8, 4};
  if (i < 0) return cudaErrorInvalidValue;
  return bank_gemm::with_config(i / 3, [&](auto cfg) {
    using T = decltype(cfg);
    return bank_gemm::with_width(widths[i % 3], [&](auto w) {
      constexpr int W = decltype(w)::value;
      const cudaError_t err =
          bank_gemm::allow_smem<bank_mxv_pop_kernel<T, W>, T::SMEM>();
      if (err != cudaSuccess) return err;
      return fill(bank_mxv_pop_kernel<T, W>, BANK_MXV_POP, i / 3, W, 0,
                  T::THREADS, T::SMEM, T::MIN_BLOCKS, out);
    });
  });
}

// checked.cuh's hook of this source's kernel.
int ck::hooks::bank_mxv_pop(const long long* table, int n, long long* record,
                            cudaStream_t stream) {
  return ck::hook(kernel_attributes::BANK_MXV_POP, table, n, record, stream);
}
