// The tiled fp32 GEMM shared by bank_mxv_pop.cu and bank_qmm_pop.cu:
// out[p] = x[p] @ B_p, where each kernel supplies how a (BK x BN) tile of
// the lane's weight B_p reaches shared memory (a bank row copied in place,
// or a packed container dequantized on the way).
//
// Exactness, the one rule every configuration keeps: each output element is
// one fmaf chain over k = 0 .. m-1 in order, starting from +0.0f, followed by
// fmaf(0, 0, acc) terms for the zero-filled k >= m tail of the last K tile
// (BK = 16 in every configuration, so the tail is the same everywhere). No
// split-K, no atomics, no TF32, no reassociation. So every configuration
// gives bitwise the same output, the result does not depend on M, N or P,
// and bank_qmm_pop(x, packed, idx) equals bank_mxv_pop(x, dequant(packed),
// idx) bitwise.
//
// What bounds it on an H100: fp32 FMA on the CUDA cores (67 TFLOP/s; the
// parity rules keep TF32 and wgmma out) at the search shapes, and bytes plus
// latency at the serving shapes (16 rows per lane). The design:
// - Register tile: TM x 8 outputs per thread inside a BM x BN block tile.
//   x's tile is stored k-major, so a thread reads its TM rows as float4s
//   (runs of 4 rows, 16 bytes apart across a warp: conflict-free) and its
//   8 columns as two float4 runs BN/2 apart (contiguous across a warp). At
//   TM = 16 a thread reads 24 floats per k step for 128 FMAs, 6 shared
//   reads: 0.75 bytes of shared memory per FMA, against 2 for the 4 x 4
//   tile this replaced and the SM's 1 (128 bytes a clock for 128 FMA
//   lanes).
// - A STAGES-deep ring in dynamic shared memory: while the block computes
//   stage t, the copies of stage t + STAGES - 1 are in flight: cp.async for
//   x (4 bytes an element, transposed on the way, so any m and any x
//   alignment) and f32 bank rows; plain loads held in registers, dequantized
//   after the stage's FMAs, for packed containers.
// - The bank rows' cp.async width W (16, 8 or 4 bytes) is a template
//   parameter chosen at launch so that it divides the row stride and the
//   base pointer: N = 1650 floats is 8-byte aligned only, and the wrappers
//   pad nothing. Ragged M, N and m are masked here (zero-filled copies,
//   masked stores).
#pragma once
#include <cuda_runtime.h>

namespace bank_gemm {

// One block-tile configuration: a BM x BN output tile, TM x 8 outputs per
// thread, a STAGES-deep ring, MIN_BLOCKS blocks an SM (the launch bounds).
template <int BM_, int BN_, int TM_, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = 16, TM = TM_, TN = 8;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int TX = BN / 8, TY = BM / TM;
  static constexpr int THREADS = TX * TY;
  // a thread's rows come in runs of GA, read as one float4 (float2)
  static constexpr int GA = TM < 4 ? TM : 4;
  static constexpr int AST = BM + 4;  // As: k-major, row stride in floats
  static constexpr int A_STAGE = BK * AST, B_STAGE = BK * BN;  // floats
  static constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * 4;  // bytes
  static_assert(THREADS % 32 == 0 && 32 % TX == 0,
                "whole warps of whole rows");
  static_assert(TM % GA == 0 && (GA == 2 || GA == 4), "float2/float4 runs");
  static_assert(THREADS % BK == 0 && BM % (THREADS / BK) == 0, "A copies");
};

// The configurations (kernels/ops.py BANK_CONFIGS mirrors these numbers):
// 0: 128 x 128, 16 x 8 per thread, the search's large M; 1: 128 x 64,
// 8 x 8 per thread, three blocks an SM, for shapes whose grid fills the card
// better in smaller tiles (Pr, N = 256); 2: 16 x 64, the serving step (16
// rows per lane and the 7-row tails). Shared memory delivers 128 bytes a
// clock to an SM's 128 FMA lanes, and a thread reads (TM + 8) floats per k
// for TM * 8 FMAs: 16 x 8 needs 0.75 bytes per FMA, 8 x 8 needs 1.0.
using Config0 = Tile<128, 128, 16, 4, 2>;
using Config1 = Tile<128, 64, 8, 3, 3>;
using Config2 = Tile<16, 64, 2, 4, 8>;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// W bytes from src to shared dst; bytes past src_bytes (0 or W) are zeros.
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(W), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies (BM x BK) tiles of row-major `src` (rows x cols), rows row0 on,
// into k-major stages (dst[k * AST + r]), transposed on the way: one 4-byte
// copy per element, a row's 16 k values to 16 neighbouring threads.
// Elements outside the matrix are zero-filled. Transposing here lets the
// inner loop read a thread's rows as float4s, 6 shared reads per 128 FMAs.
// Built once per block, so each K tile costs a pointer step and a copy per
// element.
template <class T>
struct ACopier {
  static constexpr int STEP = T::THREADS / T::BK, COPIES = T::BM / STEP;
  static_assert(COPIES <= 32, "one bit per copy");
  const float* src;
  const float* from;  // this thread's first element at k0 = 0
  long long step;     // STEP rows, in floats
  int k, cols, dst0;
  unsigned rows_ok;   // bit i: row r + i * STEP lies inside the matrix

  __device__ __forceinline__ ACopier(const float* __restrict__ src_, int rows,
                                     int cols_, int row0)
      : src(src_), k(threadIdx.x % T::BK), cols(cols_) {
    const int r = threadIdx.x / T::BK;
    from = src + static_cast<long long>(row0 + r) * cols + k;
    step = static_cast<long long>(STEP) * cols;
    dst0 = k * T::AST + r;
    rows_ok = 0;
#pragma unroll
    for (int i = 0; i < COPIES; ++i)
      rows_ok |= static_cast<unsigned>(row0 + r + i * STEP < rows) << i;
  }

  __device__ __forceinline__ void copy(float* dst, int k0) const {
    const float* p = from + k0;
    const bool k_ok = k0 + k < cols;
#pragma unroll
    for (int i = 0; i < COPIES; ++i, p += step) {
      const bool ok = k_ok && ((rows_ok >> i) & 1u);
      cp_async<4>(dst + dst0 + i * STEP, ok ? p : src, ok ? 4 : 0);
    }
  }
};

// Copies (BK x BN) tiles of row-major `src` (rows x cols), columns col0 on,
// into stages of row stride BN floats, W bytes per copy; the caller
// guarantees that W divides cols * 4 and the base pointer's alignment, so a
// W-byte vector lies wholly inside the matrix or wholly outside (then it is
// zero-filled). A B loader for gemm_tile: the copies land by themselves, so
// put has nothing to do.
template <class T, int W>
struct BCopier {
  static constexpr int VW = W / 4, VPR = T::BN / VW, STEP = T::THREADS / VPR;
  static_assert(T::THREADS % VPR == 0 && T::BK % STEP == 0, "B copies");
  const float* src;
  const float* from;  // this thread's first vector at k0 = 0
  long long step;     // STEP rows, in floats
  int r, rows, cols, dst0;
  bool col_ok;

  __device__ __forceinline__ BCopier(const float* __restrict__ src_, int rows_,
                                     int cols_, int col0)
      : src(src_), r(threadIdx.x / VPR), rows(rows_), cols(cols_) {
    const int c = (threadIdx.x % VPR) * VW;
    from = src + static_cast<long long>(r) * cols + col0 + c;
    step = static_cast<long long>(STEP) * cols;
    dst0 = r * T::BN + c;
    col_ok = col0 + c < cols;
  }

  __device__ __forceinline__ void put(float*, int) const {}

  __device__ __forceinline__ void fetch(float* dst, int k0) const {
    const float* p = from + static_cast<long long>(k0) * cols;
#pragma unroll
    for (int i = 0; i < T::BK / STEP; ++i, p += step) {
      const bool ok = col_ok && k0 + r + i * STEP < rows;
      cp_async<W>(dst + dst0 + i * STEP * T::BN, ok ? p : src, ok ? W : 0);
    }
  }
};

// x: this lane's (M, m) activations; out: its (M, N) output; smem: the
// dynamic shared memory (T::SMEM bytes). The B loader has
//   fetch(float* slot, int k0): start the reads of the K tile at k0
//     (cp.async into slot, or loads into registers);
//   put(float* slot, int k0): finish it (nothing, or dequantize the held
//     registers into slot). put runs after the current stage's FMAs, so
//     the loads' latency hides behind them.
template <class T, class BLoader>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ x,
                                          float* __restrict__ out, int M,
                                          int m, int N, BLoader& load_b,
                                          float* smem) {
  float* As = smem;
  float* Bs = smem + T::STAGES * T::A_STAGE;
  const int tid = threadIdx.x;
  const int tx = tid % T::TX, ty = tid / T::TX;
  const int row0 = blockIdx.y * T::BM, col0 = blockIdx.x * T::BN;
  const int ktiles = (m + T::BK - 1) / T::BK;
  const ACopier<T> copy_a(x, M, m, row0);

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < ktiles) {
      copy_a.copy(As + s * T::A_STAGE, s * T::BK);
      load_b.fetch(Bs + s * T::B_STAGE, s * T::BK);
      load_b.put(Bs + s * T::B_STAGE, s * T::BK);
    }
    cp_async_commit();
  }

  // rows ty * GA + g * TY * GA + (0 .. GA-1); columns tx * 4 + (0 .. 3) and
  // BN / 2 + tx * 4 + (0 .. 3)
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < ktiles; ++t) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // stage t landed; every thread is done with stage t-1
    const int nt = t + T::STAGES - 1;
    float* b_next = Bs + (nt % T::STAGES) * T::B_STAGE;
    if (nt < ktiles) {
      copy_a.copy(As + (nt % T::STAGES) * T::A_STAGE, nt * T::BK);
      load_b.fetch(b_next, nt * T::BK);
    }
    cp_async_commit();

    const float* a_s = As + (t % T::STAGES) * T::A_STAGE + ty * T::GA;
    const float* b_s = Bs + (t % T::STAGES) * T::B_STAGE + tx * 4;
#pragma unroll
    for (int kk = 0; kk < T::BK; ++kk) {
      float a[T::TM];
#pragma unroll
      for (int g = 0; g < T::TM / T::GA; ++g) {
        const float* p = a_s + kk * T::AST + g * T::TY * T::GA;
        if constexpr (T::GA == 4) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          a[4 * g] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z;
          a[4 * g + 3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(p);
          a[2 * g] = v.x; a[2 * g + 1] = v.y;
        }
      }
      const float* brow = b_s + kk * T::BN;
      const float4 b0 = *reinterpret_cast<const float4*>(brow);
      const float4 b1 = *reinterpret_cast<const float4*>(brow + T::BN / 2);
      const float b[T::TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (nt < ktiles) load_b.put(b_next, nt * T::BK);
  }
  cp_async_wait<0>();

  const bool vec = (N & 3) == 0;  // rows of `out` are 16-byte aligned
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int gr = row0 + ty * T::GA + (i / T::GA) * T::TY * T::GA + i % T::GA;
    if (gr >= M) continue;
    float* orow = out + static_cast<long long>(gr) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = col0 + h * (T::BN / 2) + tx * 4;
      const float* v = &acc[i][h * 4];
      if (vec && gc + 3 < N) {
        *reinterpret_cast<float4*>(orow + gc) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < N) orow[gc + j] = v[j];
      }
    }
  }
}

// Fills this block's output tile with NaN: the lane's menu index was out of
// range, and a visible NaN beats reading another allocation's memory.
template <class T>
__device__ __forceinline__ void poison_tile(float* __restrict__ out, int M,
                                            int N) {
  const int row0 = blockIdx.y * T::BM, col0 = blockIdx.x * T::BN;
  for (int e = threadIdx.x; e < T::BM * T::BN; e += T::THREADS) {
    const int gr = row0 + e / T::BN, gc = col0 + e % T::BN;
    if (gr < M && gc < N)
      out[static_cast<long long>(gr) * N + gc] = __int_as_float(0x7fc00000);
  }
}

template <class T>
inline dim3 grid_for(int P, int M, int N) {
  return dim3((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, P);
}

// Raises kernel K's dynamic shared-memory limit to SMEM bytes the first time
// this instantiation launches; returns that call's CUDA error.
template <auto K, int SMEM>
inline cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      K, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  return err;
}

// f(ConfigN{}) for configuration `config`; cudaErrorInvalidValue for an
// unknown one.
template <class F>
inline cudaError_t with_config(int config, F&& f) {
  switch (config) {
    case 0: return f(Config0{});
    case 1: return f(Config1{});
    case 2: return f(Config2{});
    default: return cudaErrorInvalidValue;
  }
}

template <int W>
struct Width {
  static constexpr int value = W;
};

// f(Width<W>{}) for a copy width of 16, 8 or 4 bytes.
template <class F>
inline cudaError_t with_width(int width, F&& f) {
  switch (width) {
    case 16: return f(Width<16>{});
    case 8: return f(Width<8>{});
    case 4: return f(Width<4>{});
    default: return cudaErrorInvalidValue;
  }
}

// Block-tile numbers of configuration `config` into out[0..7]: BM, BN, BK,
// TM, STAGES, THREADS, MIN_BLOCKS, dynamic shared-memory bytes.
inline cudaError_t config_info(int config, int* out) {
  return with_config(config, [&](auto cfg) {
    using T = decltype(cfg);
    const int v[8] = {T::BM,     T::BN,      T::BK,         T::TM,
                      T::STAGES, T::THREADS, T::MIN_BLOCKS, T::SMEM};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return cudaSuccess;
  });
}

}  // namespace bank_gemm
