// The tiled fp32 GEMM shared by bank_mxv_pop.cu and bank_qmm_pop.cu:
// out[p] = x[p] @ B_p, where each kernel supplies how a (BK x BN) tile of
// the lane's weight B_p is loaded (a bank row read in place, or a packed
// container dequantized on the way to shared memory).
//
// Both kernels run this one body, so for the same weight values they
// compute every output with the same sequence of fmaf calls, and
// bank_qmm_pop(x, packed, idx) equals bank_mxv_pop(x, dequant(packed), idx)
// bitwise. Each output element sums k = 0 .. m-1 in order, whatever tile it
// falls in, so the result does not depend on M or N either.
//
// Tiling: a 64 x 64 output tile per block of 256 threads, 4 x 4 outputs per
// thread, K in steps of 16 through shared memory. fp32 FMA on the CUDA
// cores only: no TF32 and no tensor cores, so the result is held to the
// plain fp32 torch.bmm at rtol 1e-4 / atol 1e-3. Ragged M, N and m are
// masked here (zeros in, nothing out), so callers pad nothing.
#pragma once
#include <cuda_runtime.h>

namespace bank_gemm {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int APAD = 4;  // keeps As rows 16-byte aligned, halves conflicts

// x: this lane's (M, m) activations; out: its (M, N) output.
template <class BLoader>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ x,
                                          float* __restrict__ out, int M,
                                          int m, int N, const BLoader& load_b) {
  __shared__ __align__(16) float As[BK][BM + APAD];  // As[k][row]
  __shared__ __align__(16) float Bs[BK][BN];         // Bs[k][col]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < m; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int rr = e / BK, kk = e % BK;  // a row's 16 k values per 16 threads
      const int gr = row0 + rr, gk = k0 + kk;
      As[kk][rr] = (gr < M && gk < m)
                       ? x[static_cast<long long>(gr) * m + gk]
                       : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / BN, cc = e % BN;  // neighbouring threads, columns
      const int gk = k0 + kk, gc = col0 + cc;
      Bs[kk][cc] = (gk < m && gc < N) ? load_b(gk, gc) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < N) out[static_cast<long long>(gr) * N + gc] = acc[i][j];
    }
  }
}

// Fills this block's output tile with NaN: the lane's menu index was out of
// range, and a visible NaN beats reading another allocation's memory.
__device__ __forceinline__ void poison_tile(float* __restrict__ out, int M,
                                            int N) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int gr = row0 + e / BN, gc = col0 + e % BN;
    if (gr < M && gc < N)
      out[static_cast<long long>(gr) * N + gc] = __int_as_float(0x7fc00000);
  }
}

inline dim3 grid_for(int P, int M, int N) {
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM, P);
}

}  // namespace bank_gemm
