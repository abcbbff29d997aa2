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
// What bounds it on an H100: operations at the search shapes, as for
// bank_mxv_pop (the same GEMM; the weight bytes are 1/16 to 1/2 of the f32
// row's); bytes and the K loop's latency at the serving shapes.
//
// Design: bank_gemm.cuh's tile, ring and inner loop, shared with
// bank_mxv_pop; only the B loader differs. The menu index is uniform per
// block, so the loader's two steps branch once per K tile on the container
// (PackedLoader::fetch_as / put_as<R codes per element, E bytes>): each
// thread loads a fixed run of the selected container's bytes for the next K
// tile with vector loads (width chosen by the wrapper from N and the
// containers' alignment: N = 1650 bytes allows 2), holds them in registers
// while the block computes the current stage, then unpacks, sign-extends
// and multiplies each code by its column's scale (held in shared memory;
// __fmul_rn, never fused) into the f32 B stage. Each dequantized element is
// bitwise the f32 bank's, codes for k >= m are written as +0 exactly as
// bank_mxv_pop's zero-filled copies, and the GEMM sums in the same order, so
// this kernel equals bank_mxv_pop on the dequantized bank bitwise. The TPU
// kernel unpacked all four containers and picked one with `where`; this one
// reads only the selected container.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bank_gemm.cuh"
#include "checked.cuh"
#include "kernel_attributes.cuh"

namespace {

// The C entry's pointer parameters, in order (checked.cuh's extents).
enum Param { X, Q2, Q4, Q8, Q16, SCALE, IDX, OUT };

// How a block's threads share one container's (BK x BN) tile: R codes per
// element along K (q2: 4, q4: 2, q8 and q16: 1), E bytes per element. Each
// thread holds RB bytes of one container row, COLS columns from c_local.
template <class T, int R, int E>
struct Run {
  static constexpr int RB = (T::BK / R) * T::BN * E / T::THREADS;
  static constexpr int CPR = T::BN * E / RB;  // threads per container row
  static constexpr int COLS = RB / E;
  static_assert(RB >= E && (T::BK / R) * CPR == T::THREADS,
                "one run of whole codes per thread");
};

// The B loader of bank_qmm_pop: one type for all four containers, so that
// the block runs one copy of the GEMM's main loop whatever its lane's menu
// index (four copies of a loop of ~1,400 instructions, run side by side on
// an SM, would compete for its instruction cache); only fetch and put
// branch on the container, uniformly per block.
template <class T>
struct PackedLoader {
  static constexpr int WORDS = (Run<T, 1, 2>::RB + 3) / 4;  // q16: the most
  const uint8_t* __restrict__ base;  // the selected container
  const float* sscale;  // the block's BN column scales, in shared memory
  int sel, rows, m, N, col0;
  int width;            // vector load bytes, divides N * E and base
  uint32_t w[WORDS];    // the held bytes of the next tile

  // the container's parameter: Q2 + sel
  template <class G, int V, int E>
  __device__ __forceinline__ void load(int gr, int c) {
    const uint8_t* src = base + (static_cast<long long>(gr) * N + c) * E;
#pragma unroll
    for (int b = 0; b < G::RB; b += V) {
      const bool ok = gr < rows && c + b / E < N;  // whole vectors in or out
      if constexpr (V == 16) {
        const uint4 v =
            ok ? CK_LD(Q2 + sel, reinterpret_cast<const uint4*>(src + b))
               : make_uint4(0, 0, 0, 0);
        w[b / 4] = v.x; w[b / 4 + 1] = v.y; w[b / 4 + 2] = v.z;
        w[b / 4 + 3] = v.w;
      } else if constexpr (V == 8) {
        const uint2 v =
            ok ? CK_LD(Q2 + sel, reinterpret_cast<const uint2*>(src + b))
               : make_uint2(0, 0);
        w[b / 4] = v.x; w[b / 4 + 1] = v.y;
      } else if constexpr (V == 4) {
        w[b / 4] =
            ok ? CK_LD(Q2 + sel, reinterpret_cast<const uint32_t*>(src + b))
               : 0u;
      } else if constexpr (V == 2) {
        const uint32_t v =
            ok ? CK_LD(Q2 + sel, reinterpret_cast<const uint16_t*>(src + b))
               : 0u;
        w[b / 4] = (b % 4 ? w[b / 4] : 0u) | (v << (8 * (b % 4)));
      } else {
        const uint32_t v = ok ? CK_LD(Q2 + sel, src + b) : 0u;
        w[b / 4] = (b % 4 ? w[b / 4] : 0u) | (v << (8 * (b % 4)));
      }
    }
  }

  // Loads this thread's bytes of the K tile at k0 into registers.
  template <int R, int E>
  __device__ __forceinline__ void fetch_as(int k0) {
    using G = Run<T, R, E>;
    const int gr = k0 / R + static_cast<int>(threadIdx.x) / G::CPR;
    const int c = col0 + (threadIdx.x % G::CPR) * G::COLS;
    const int v = width < G::RB ? width : G::RB;  // uniform over the grid
    if constexpr (G::RB >= 16) {
      if (v == 16) return load<G, 16, E>(gr, c);
    }
    if constexpr (G::RB >= 8) {
      if (v == 8) return load<G, 8, E>(gr, c);
    }
    if constexpr (G::RB >= 4) {
      if (v == 4) return load<G, 4, E>(gr, c);
    }
    if constexpr (G::RB >= 2) {
      if (v == 2) return load<G, 2, E>(gr, c);
    }
    if constexpr (E == 1) load<G, 1, E>(gr, c);
  }

  // Code j of sub-row s as a float, exactly: the code plus 1.5 * 2^23 is
  // an integer the float format holds with a fixed exponent, so integer
  // adds build it and one float subtraction returns the code. Two
  // full-rate instructions in place of I2F, which the SM runs at an eighth
  // of the FMA rate.
  template <int R, int E>
  __device__ __forceinline__ float code(int j, int s) const {
    constexpr int MAGIC = 0x4B400000;  // 12582912.0f
    const int bj = j * E;
    const uint32_t u = w[bj / 4] >> (8 * (bj % 4));
    int c;
    if constexpr (E == 2) {
      c = static_cast<int16_t>(u & 0xFFFFu);
    } else if constexpr (R == 1) {
      c = static_cast<int8_t>(u & 0xFFu);
    } else {
      constexpr int BITS = 8 / R;
      const int v = (u >> (BITS * s)) & ((1 << BITS) - 1);
      c = v - ((v & (1 << (BITS - 1))) ? (1 << BITS) : 0);
    }
    return __int_as_float(MAGIC + c) - 12582912.0f;
  }

  // Unpacks, sign-extends and scales the held codes into the f32 stage;
  // codes for k >= m become +0, as bank_mxv_pop's zero-filled copies.
  template <int R, int E>
  __device__ __forceinline__ void put_as(float* slot, int k0) const {
    using G = Run<T, R, E>;
    const int kr = threadIdx.x / G::CPR;
    const int c_local = (threadIdx.x % G::CPR) * G::COLS;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int kl = kr * R + s;
      const bool kok = k0 + kl < m;
      float sc[G::COLS], v[G::COLS];
      if constexpr (G::COLS % 4 == 0) {
#pragma unroll
        for (int j = 0; j < G::COLS; j += 4) {
          const float4 q = CK_SH_LD(
              reinterpret_cast<const float4*>(sscale + c_local + j));
          sc[j] = q.x; sc[j + 1] = q.y; sc[j + 2] = q.z; sc[j + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < G::COLS; ++j)
          sc[j] = CK_SH_LD(sscale + (c_local + j));
      }
#pragma unroll
      for (int j = 0; j < G::COLS; ++j)
        v[j] = kok ? __fmul_rn(code<R, E>(j, s), sc[j]) : 0.0f;
      float* dst = slot + kl * T::BN + c_local;
      if constexpr (G::COLS % 4 == 0) {
#pragma unroll
        for (int j = 0; j < G::COLS; j += 4)
          CK_SH_ST(reinterpret_cast<float4*>(dst + j),
                   make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]));
      } else {
#pragma unroll
        for (int j = 0; j < G::COLS; ++j) CK_SH_ST(dst + j, v[j]);
      }
    }
  }

  __device__ __forceinline__ void fetch(float*, int k0) {
    switch (sel) {
      case 0: fetch_as<4, 1>(k0); break;
      case 1: fetch_as<2, 1>(k0); break;
      case 2: fetch_as<1, 1>(k0); break;
      default: fetch_as<1, 2>(k0);
    }
  }

  __device__ __forceinline__ void put(float* slot, int k0) const {
    switch (sel) {
      case 0: put_as<4, 1>(slot, k0); break;
      case 1: put_as<2, 1>(slot, k0); break;
      case 2: put_as<1, 1>(slot, k0); break;
      default: put_as<1, 2>(slot, k0);
    }
  }
};

// Dynamic shared memory of a block: the rings, then the BN column scales.
template <class T>
constexpr int SMEM = T::SMEM + T::BN * 4;

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    bank_qmm_pop_kernel(const float* __restrict__ x,
                        const int8_t* __restrict__ q2,
                        const int8_t* __restrict__ q4,
                        const int8_t* __restrict__ q8,
                        const int16_t* __restrict__ q16,
                        const float* __restrict__ scale, int scale_cols,
                        const int* __restrict__ idx, float* __restrict__ out,
                        int M, int m, int N, int width8, int width16) {
  extern __shared__ float4 smem[];
  CK_SHARED_ARRAY(smem, SMEM<T>);
  float* sm = reinterpret_cast<float*>(smem);
  const int p = blockIdx.z;
  const int sel = CK_LD(IDX, idx + p);  // uniform per block
  float* lane_out = out + static_cast<long long>(p) * M * N;
  if (sel < 0 || sel > 3) {
    bank_gemm::poison_tile<T, OUT>(lane_out, M, N);
    return;
  }
  // the block's column scales, after the rings in shared memory (a global
  // load in put would stall every stage)
  const int col0 = blockIdx.x * T::BN;
  const float* srow = scale + static_cast<long long>(sel) * scale_cols;
  float* sscale = sm + T::SMEM / 4;
  for (int j = threadIdx.x; j < T::BN; j += T::THREADS)
    CK_SH_ST(sscale + j, scale_cols == 1 ? CK_LD(SCALE, srow)
                         : (col0 + j < N ? CK_LD(SCALE, srow + (col0 + j))
                                         : 0.0f));
  __syncthreads();
  const void* container = sel == 0 ? static_cast<const void*>(q2)
                          : sel == 1 ? static_cast<const void*>(q4)
                          : sel == 2 ? static_cast<const void*>(q8)
                                     : static_cast<const void*>(q16);
  const int rows = sel == 0 ? (m + 3) / 4 : sel == 1 ? (m + 1) / 2 : m;
  PackedLoader<T> load{static_cast<const uint8_t*>(container), sscale, sel,
                       rows, m, N, col0, sel == 3 ? width16 : width8, {}};
  bank_gemm::gemm_tile<T, X, OUT>(x + static_cast<long long>(p) * M * m,
                                  lane_out, M, m, N, load, sm);
}

}  // namespace

// x: (P, M, m) f32; containers as above; idx: (P,) int32 on the device;
// out: (P, M, N) f32. All contiguous. config: a bank_gemm configuration
// (0-2); width8 / width16: the load width in bytes for the int8 containers
// (1-16, dividing N and their alignment) and for q16 (2-16, dividing 2 N
// and its alignment). Returns the CUDA error of the launch (or of raising
// its shared-memory limit).
extern "C" int repro_bank_qmm_pop(const float* x, const int8_t* q2,
                                  const int8_t* q4, const int8_t* q8,
                                  const int16_t* q16, const float* scale,
                                  int scale_cols, const int* idx, float* out,
                                  int P, int M, int m, int N, int config,
                                  int width8, int width16, void* stream) {
  return static_cast<int>(bank_gemm::with_config(config, [&](auto cfg) {
    using T = decltype(cfg);
    const cudaError_t err =
        bank_gemm::allow_smem<bank_qmm_pop_kernel<T>, SMEM<T>>();
    if (err != cudaSuccess) return err;
    bank_qmm_pop_kernel<T><<<bank_gemm::grid_for<T>(P, M, N), T::THREADS,
                             SMEM<T>, static_cast<cudaStream_t>(stream)>>>(
        x, q2, q4, q8, q16, scale, scale_cols, idx, out, M, m, N, width8,
        width16);
    return cudaGetLastError();
  }));
}

// The records of kernel_attributes.cuh: configuration i, its launch's
// shared memory allowed first.
cudaError_t kernel_attributes::bank_qmm_pop(int i, int* out) {
  return bank_gemm::with_config(i, [&](auto cfg) {
    using T = decltype(cfg);
    const cudaError_t err =
        bank_gemm::allow_smem<bank_qmm_pop_kernel<T>, SMEM<T>>();
    if (err != cudaSuccess) return err;
    return fill(bank_qmm_pop_kernel<T>, BANK_QMM_POP, i, 0, 0, T::THREADS,
                SMEM<T>, T::MIN_BLOCKS, out);
  });
}

// checked.cuh's hook of this source's kernel.
int ck::hooks::bank_qmm_pop(const long long* table, int n, long long* record,
                            cudaStream_t stream) {
  return ck::hook(kernel_attributes::BANK_QMM_POP, table, n, record, stream);
}
