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
// What bounds it on an H100: bytes. Each (lane, sequence, channel) reads
// three f32 streams and writes two, once each, and does ~20 flops per step:
// far below the card's 20 flop/byte balance point. At the main path's
// shape (P=16, B=32, T=48, n=550) that is ~270 MB, ~81 us at 3.35 TB/s.
//
// Design: one thread per (p, b, channel). The state c and the four shared
// per-channel vectors stay in registers for all T steps, so the only memory
// traffic is the one pass over the streams. Neighbouring threads take
// neighbouring channels, so every load and store of a warp is one coalesced
// row segment. The time loop is sequential by nature; the parallelism is
// P*B*n threads (281k at the main path's shape, enough for 132 SMs). The
// streams may be column slices of a wider (..., T, ld) array (uw, uf, ur
// are the three n-wide thirds of one MxV output), so the caller need not
// copy them apart.
//
// Arithmetic is spelled with __fmul_rn/__fadd_rn so that nvcc cannot fuse
// it into FMAs: each step rounds exactly where the plain PyTorch version
// (kernels/ref.py::sru_scan_pop_ref) rounds. The sigmoid uses expf and an
// IEEE division (no fast math), within 1e-5 of torch.sigmoid.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
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
  const float vfj = vf[j], vrj = vr[j], bfj = bf[j], brj = br[j];
  long long in = pb * T * ld + j;
  long long out = pb * T * n + j;
  float c = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float xw = uw[in], xf = uf[in], xr = ur[in];
    const float f = sigmoid_f(__fadd_rn(__fadd_rn(xf, __fmul_rn(vfj, c)), bfj));
    const float rr =
        sigmoid_f(__fadd_rn(__fadd_rn(xr, __fmul_rn(vrj, c)), brj));
    c = __fadd_rn(__fmul_rn(f, c), __fmul_rn(__fsub_rn(1.0f, f), xw));
    h[out] = __fmul_rn(rr, c);
    r[out] = rr;
    in += ld;
    out += n;
  }
  c_last[pb * n + j] = c;
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
  const long long threads = PB * n;
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  sru_scan_pop_kernel<<<static_cast<unsigned>(grid), block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      uw, uf, ur, ld, vf, vr, bf, br, h, r, c_last, PB, T, n);
  return static_cast<int>(cudaGetLastError());
}
