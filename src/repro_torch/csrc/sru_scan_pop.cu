// SRU element-wise recurrence over a population of quantization lanes.
//
// Replaces: the Pallas kernels src/repro/kernels/sru_scan.py::sru_scan_pop
// (body _sru_kernel_pop) and, launched with P = 1, sru_scan (body
// _sru_kernel).
//
//   f_t = sigmoid(uf_t + v_f * c + b_f)
//   r_t = sigmoid(ur_t + v_r * c + b_r)
//   c   = f_t * c + (1 - f_t) * uw_t
//   h_t = r_t * c
//
// What bounds it on an H100: bytes at the search's population shape, and
// latency at P = 1 and at the serving shapes. Each (lane, sequence, channel)
// reads three f32 streams and writes two, once each, and does ~20 flops per
// step: far below the card's 20 flop/byte balance point. At (P=16, B=32,
// T=48, n=550) that is ~270 MB, ~81 us at 3.35 TB/s. At P = 1 the same
// shape is 17 MB (~5 us), and the 48 dependent steps of one channel, each a
// chain through expf and an IEEE division, are what the time cannot go
// below.
//
// Design: one thread per (p, b, channel). The state c and the four shared
// per-channel vectors stay in registers for all T steps, so the only memory
// traffic is the one pass over the streams. Neighbouring threads take
// neighbouring channels, so every load and store of a warp is one coalesced
// row segment. The streams may be column slices of a wider (..., T, ld)
// array (uw, uf, ur are the three n-wide thirds of one MxV output), so the
// caller need not copy them apart.
//
// - Time steps are prefetched: a thread loads the three streams of TC = 8
//   steps into registers, and issues the next TC steps' loads before it
//   runs the current steps' recurrence (a register double buffer, unrolled
//   by two so that no registers are copied). A step then waits on its
//   arithmetic, not on DRAM: 3 * TC loads a thread are in flight while
//   3 * TC more are consumed. Stores of h and r are fire-and-forget. Ragged
//   T (T mod TC != 0, T = 1) is masked here. 8 steps a stage (76 registers)
//   were faster than 4 or 16 at the search's population shape and as fast
//   at P = 1.
// - Blocks of 256 threads. At P = 1, (32, 48, 550) is 17,600 threads, 69
//   blocks on 132 SMs; blocks of 32 to 128 threads, which spread the same
//   threads over every SM, ran no faster there (the 48 dependent steps of
//   one channel set the time) and slower at the population shape.
//
// Arithmetic is spelled with __fmul_rn/__fadd_rn so that nvcc cannot fuse
// it into FMAs: each step rounds exactly where the plain PyTorch version
// (kernels/ref.py::sru_scan_pop_ref) rounds. The sigmoid uses expf and an
// IEEE division (no fast math), within 1e-5 of torch.sigmoid. A thread's
// steps do not depend on P, so a P = 1 launch agrees bit for bit with the
// same lane of a population launch.
#include <cuda_runtime.h>

#include "checked.cuh"
#include "kernel_attributes.cuh"

namespace {

// The C entry's pointer parameters, in order (checked.cuh's extents).
enum Param { UW, UF, UR, VF, VR, BF, BR, H, R, C_LAST };

constexpr int TC = 8;              // time steps a prefetch stage
constexpr int BLOCK = 256;         // threads a block

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Streams of steps t0 .. t0+TC-1 into registers; steps past T read nothing.
__device__ __forceinline__ void load_steps(
    const float* __restrict__ uw, const float* __restrict__ uf,
    const float* __restrict__ ur, long long in, long long ld, int t0, int T,
    float (&xw)[TC], float (&xf)[TC], float (&xr)[TC]) {
#pragma unroll
  for (int i = 0; i < TC; ++i) {
    if (t0 + i < T) {
      const long long at = in + static_cast<long long>(t0 + i) * ld;
      xw[i] = CK_LDG(UW, uw + at);
      xf[i] = CK_LDG(UF, uf + at);
      xr[i] = CK_LDG(UR, ur + at);
    }
  }
}

__device__ __forceinline__ void run_steps(
    const float (&xw)[TC], const float (&xf)[TC], const float (&xr)[TC],
    float vfj, float vrj, float bfj, float brj, float& c,
    float* __restrict__ h, float* __restrict__ r, long long out, int n,
    int t0, int T) {
#pragma unroll
  for (int i = 0; i < TC; ++i) {
    if (t0 + i < T) {
      const float f =
          sigmoid_f(__fadd_rn(__fadd_rn(xf[i], __fmul_rn(vfj, c)), bfj));
      const float rr =
          sigmoid_f(__fadd_rn(__fadd_rn(xr[i], __fmul_rn(vrj, c)), brj));
      c = __fadd_rn(__fmul_rn(f, c), __fmul_rn(__fsub_rn(1.0f, f), xw[i]));
      const long long at = out + static_cast<long long>(t0 + i) * n;
      CK_ST(H, h + at, __fmul_rn(rr, c));
      CK_ST(R, r + at, rr);
    }
  }
}

__global__ void sru_scan_pop_kernel(const float* __restrict__ uw,
                                    const float* __restrict__ uf,
                                    const float* __restrict__ ur, long long ld,
                                    const float* __restrict__ vf,
                                    const float* __restrict__ vr,
                                    const float* __restrict__ bf,
                                    const float* __restrict__ br,
                                    float* __restrict__ h,
                                    float* __restrict__ r,
                                    float* __restrict__ c_last, long long PB,
                                    int T, int n) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= PB * n) return;
  const int j = static_cast<int>(tid % n);
  const long long pb = tid / n;
  const long long in = pb * T * ld + j;
  const long long out = pb * T * n + j;
  float aw[TC], af[TC], ar[TC], bw[TC], bfs[TC], brs[TC];
  load_steps(uw, uf, ur, in, ld, 0, T, aw, af, ar);
  const float vfj = CK_LD(VF, vf + j), vrj = CK_LD(VR, vr + j),
              bfj = CK_LD(BF, bf + j), brj = CK_LD(BR, br + j);
  float c = 0.0f;
  for (int t0 = 0; t0 < T; t0 += 2 * TC) {
    // buffer a holds steps t0.., b gets t0+TC.. while a is consumed, then a
    // gets t0+2TC.. while b is consumed
    load_steps(uw, uf, ur, in, ld, t0 + TC, T, bw, bfs, brs);
    run_steps(aw, af, ar, vfj, vrj, bfj, brj, c, h, r, out, n, t0, T);
    if (t0 + TC >= T) break;
    load_steps(uw, uf, ur, in, ld, t0 + 2 * TC, T, aw, af, ar);
    run_steps(bw, bfs, brs, vfj, vrj, bfj, brj, c, h, r, out, n, t0 + TC, T);
  }
  CK_ST(C_LAST, c_last + (pb * n + j), c);
}

}  // namespace

// uw/uf/ur: (P, B, T, n) rows with row stride ``ld`` (>= n) and contiguous
// channels; v/b: (n,); h, r: (P, B, T, n) contiguous; c_last: (P, B, n).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_sru_scan_pop(const float* uw, const float* uf,
                                  const float* ur, long long ld,
                                  const float* vf, const float* vr,
                                  const float* bf, const float* br, float* h,
                                  float* r, float* c_last, int P, int B, int T,
                                  int n, void* stream) {
  const long long PB = static_cast<long long>(P) * B;
  const long long grid = (PB * n + BLOCK - 1) / BLOCK;
  sru_scan_pop_kernel<<<static_cast<unsigned>(grid), BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      uw, uf, ur, ld, vf, vr, bf, br, h, r, c_last, PB, T, n);
  return static_cast<int>(cudaGetLastError());
}

// The record of kernel_attributes.cuh: the one instantiation (no launch
// bounds: a minimum of 1 block an SM).
cudaError_t kernel_attributes::sru_scan_pop(int i, int* out) {
  if (i != 0) return cudaErrorInvalidValue;
  return kernel_attributes::fill(sru_scan_pop_kernel,
                                 kernel_attributes::SRU_SCAN_POP, 0, 0, 0,
                                 BLOCK, 0, 1, out);
}

// checked.cuh's hook of this source's kernel.
int ck::hooks::sru_scan_pop(const long long* table, int n, long long* record,
                            cudaStream_t stream) {
  return ck::hook(kernel_attributes::SRU_SCAN_POP, table, n, record, stream);
}
