// Population MxV against a PACKED quantized-weight bank:
// out[p] = x[p] @ dequant(packed)[idx[p]].
//
// Replaces: the Pallas kernel src/repro/kernels/sru_scan.py::bank_qmm_pop
// (body _bank_qmm_kernel, unpack helper quant_matmul.py::_unpack_block).
//
// Containers (quantization.build_packed_weight_bank): q2 (ceil(m/4), N)
// int8 and q4 (ceil(m/2), N) int8, codes packed along the contraction axis
// low bits first; q8 (m, N) int8; q16 (m, N) int16; scale (4, C) f32 with
// C = 1 (per-tensor grid) or C = N. Menu index 0 -> 2-bit ... 3 -> 16-bit.
//
// What bounds it on an H100: operations, as for bank_mxv_pop (the same
// GEMM; the weight bytes are 1/16 to 1/2 of the f32 row's).
//
// Design: the same tile and inner loop as bank_mxv_pop (bank_gemm.cuh).
// Only the B-tile loader differs: it reads the selected container alone
// (the TPU kernel unpacked all four and picked one with `where`),
// sign-extends sub-byte codes, and multiplies by the lane's scale in f32
// (__fmul_rn, never fused) before the tile goes to shared memory. Each
// dequantized element is then bitwise the f32 bank's, and the GEMM sums it
// in the same order, so this kernel equals bank_mxv_pop on the dequantized
// bank bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bank_gemm.cuh"

namespace {

struct PackedLoader {
  const int8_t* __restrict__ q2;
  const int8_t* __restrict__ q4;
  const int8_t* __restrict__ q8;
  const int16_t* __restrict__ q16;
  const float* __restrict__ scale;  // the lane's scale row, (C,)
  int scale_cols;
  int N;
  int sel;
  __device__ __forceinline__ float operator()(int k, int c) const {
    int code;
    if (sel == 0) {
      const unsigned u = static_cast<uint8_t>(q2[static_cast<long long>(k >> 2) * N + c]);
      const int v = (u >> ((k & 3) * 2)) & 0x3;
      code = v - ((v & 0x2) ? 4 : 0);
    } else if (sel == 1) {
      const unsigned u = static_cast<uint8_t>(q4[static_cast<long long>(k >> 1) * N + c]);
      const int v = (u >> ((k & 1) * 4)) & 0xF;
      code = v - ((v & 0x8) ? 16 : 0);
    } else if (sel == 2) {
      code = q8[static_cast<long long>(k) * N + c];
    } else {
      code = q16[static_cast<long long>(k) * N + c];
    }
    const float s = scale[scale_cols == 1 ? 0 : c];
    return __fmul_rn(static_cast<float>(code), s);
  }
};

__global__ void __launch_bounds__(bank_gemm::THREADS)
    bank_qmm_pop_kernel(const float* __restrict__ x,
                        const int8_t* __restrict__ q2,
                        const int8_t* __restrict__ q4,
                        const int8_t* __restrict__ q8,
                        const int16_t* __restrict__ q16,
                        const float* __restrict__ scale, int scale_cols,
                        const int* __restrict__ idx, float* __restrict__ out,
                        int M, int m, int N) {
  const int p = blockIdx.z;
  const int sel = idx[p];
  float* lane_out = out + static_cast<long long>(p) * M * N;
  if (sel < 0 || sel > 3) {
    bank_gemm::poison_tile(lane_out, M, N);
    return;
  }
  const PackedLoader load{q2, q4, q8, q16,
                          scale + static_cast<long long>(sel) * scale_cols,
                          scale_cols, N, sel};
  bank_gemm::gemm_tile(x + static_cast<long long>(p) * M * m, lane_out, M, m,
                       N, load);
}

}  // namespace

// x: (P, M, m) f32; containers as above; idx: (P,) int32 on the device;
// out: (P, M, N) f32. All contiguous. Returns cudaGetLastError().
extern "C" int repro_bank_qmm_pop(const float* x, const int8_t* q2,
                                  const int8_t* q4, const int8_t* q8,
                                  const int16_t* q16, const float* scale,
                                  int scale_cols, const int* idx, float* out,
                                  int P, int M, int m, int N, void* stream) {
  bank_qmm_pop_kernel<<<bank_gemm::grid_for(P, M, N), bank_gemm::THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, q2, q4, q8, q16, scale, scale_cols, idx, out, M, m, N);
  return static_cast<int>(cudaGetLastError());
}
