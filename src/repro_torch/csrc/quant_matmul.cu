// Activation x packed low-bit weight product:
// y = x @ (unpack(packed, bits) * scales[None, :]), f32 accumulation.
//
// Replaces: the Pallas kernel src/repro/kernels/quant_matmul.py::quant_matmul
// (body _qmm_kernel, unpack helper _unpack_block).
//
// Layout (kernels/ref.py::pack_weights): codes packed along K, low bits
// first. Byte (r, c) of `packed` holds rows r*per .. r*per+per-1 of column
// c, per = 8 / bits, each a two's-complement field; bits = 8 is one int8 per
// byte. scales: (N,) f32, one per output column.
//
// What bounds it on an H100: bytes at int8, instructions at int4 and int2.
// On the serving path (the LM head of stablelm-1.6b) M is the batch (4),
// K = 2048 and N = 100352: the int8 container is 205.5 MB (0.062 ms at
// 3.35 TB/s) and the 822 M FMAs take 0.028 ms of the CUDA cores, so the
// product is a GEMV. Each code feeds only M FMAs, so the instructions that
// turn a code into a float decide whether int4 gains from its half bytes.
//
// Design: a block of 4 warps owns 256 columns and up to MT rows of x
// (MT = 4 when M <= 4, else 8). A thread owns 8
// adjacent columns and reads one 8-byte load per packed row, so a warp
// reads 256 consecutive bytes of a row.
// - x is staged once per block, k-major in shared memory ([k][MT], so one
//   16-byte load gives 4 rows of one k), in slices of XK values of k
//   (2048 at MT = 4: the LM head's K in one slice, 32 KB, and no barrier in
//   the K loop), with 16-byte loads where K % 4 == 0, all of a batch in
//   flight at once. Warp w takes a contiguous quarter of each slice's
//   packed rows.
// - Loads are pipelined: each thread keeps the next D = 8 packed rows in
//   flight (a register double buffer, unrolled by two) while it runs the
//   FMAs of the current 8, and asks L2 for the PF = 2 stages after those
//   (two prefetch instructions a thread a stage), so that a stage's register loads wait
//   on L2 rather than on DRAM; the first stages are issued before x is
//   staged. Reads stay coalesced; an unaligned base or N % 8 != 0 takes
//   byte loads, masked at N (the VEC = false instance).
// - No I2F: a field is moved into the low mantissa bits of 2^23
//   (0x4B000000) with its sign bit flipped (offset binary), and one FADD of
//   -(2^23 + bias) gives the exact code. int8: one XOR a word, then one
//   PRMT and one FADD a code. int4 and int2: one XOR and one shift a word
//   (columns 2 and 3 of a word are read from it shifted right by 12, so
//   that no field reaches bit 23), then one LOP3 and one FADD a code. A
//   field left in place at bit offset a(j) + bits * s (column j of the
//   word, sub-row s) gives code * 2^(a(j) + bits * s); the 2^(bits * s) is
//   divided out of x when it is staged (x[k] * 2^-(bits * (k mod per))) and
//   the 2^a(j) out of the column's sum. Multiplying by powers of two is
//   exact, so each FMA adds exactly x[k] * code * 2^a(j).
// - The scale is applied once per output column, after the K sum, not once
//   per code: that saves an FMUL a code (a sixth of int8's instructions) and
//   changes only rounding: the plain version rounds each code * scale, this
//   kernel rounds sum * scale once. Both are held to rtol 1e-4 / atol 1e-3.
// - At the end the 4 warps' partial sums are added in warp order through
//   shared memory (aliasing x's slice), so every output has one fixed
//   summation order. Ragged M, N and K are masked here: rows past M and
//   codes past K meet x = 0 in shared memory, words past the packed rows or
//   N are not read, and the wrapper pads nothing. No tensor cores: fp32 FMA
//   on the CUDA cores.
// - Grid fill and registers: 128 threads and 32 KB of shared memory a block,
//   3 blocks an SM (launch bounds: <= 168 registers, no spills), so the LM
//   head's 392 blocks are one resident wave on 132 SMs. Four columns a
//   thread (784 blocks, 6 an SM) would leave 80 registers, too few for the
//   double buffer without spills; 8 columns a thread also halve the x
//   reads, loads and shared loads a code.
#include <cuda_runtime.h>
#include <stdint.h>

#include "checked.cuh"
#include "kernel_attributes.cuh"

namespace {

// The C entry's pointer parameters, in order (checked.cuh's extents).
enum Param { X, PACKED, SCALES, OUT };

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 8;            // adjacent columns per thread
constexpr int W = COLS / 4;        // 4-byte words per thread and packed row
constexpr int BN = 32 * COLS;      // columns per block
constexpr int D = 8;               // packed rows per pipeline stage
constexpr int PF = 2;              // stages ahead of the registers in L2
constexpr unsigned MAGIC = 0x4B000000u;   // 2^23 as an f32 bit pattern

template <int MT> struct Shape {
  static constexpr int XK = MT == 4 ? 2048 : 1024;   // k per x slice
  static constexpr int MIN_BLOCKS = MT == 4 ? 3 : 2;
};

// Bytes c0 .. c0+COLS-1 of one packed row (p points at byte c0) as W
// little-endian words; without VEC byte by byte, zero past the ``ncols``
// columns left in the row.
template <bool VEC>
__device__ __forceinline__ void load_word(const int8_t* __restrict__ p,
                                          int ncols, unsigned (&w)[W]) {
  if constexpr (VEC && W == 1) {
    w[0] = CK_LDG(PACKED, reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (VEC && W == 2) {
    const uint2 v = CK_LDG(PACKED, reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      w[i] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * i + j < ncols)
          w[i] |= static_cast<unsigned>(static_cast<uint8_t>(
                      CK_LDG(PACKED, p + 4 * i + j)))
                  << (8 * j);
    }
  }
}

// (a & B) | c in one LOP3: with both B and c immediate, the compiler spends
// two instructions, so c (the magic) comes in a register.
template <unsigned B>
__device__ __forceinline__ unsigned and_or(unsigned a, unsigned c) {
  unsigned d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "n"(B), "r"(c));
  return d;
}

// Bit offset of column j's field base after the word is split (columns 2
// and 3 come from the word shifted right by 12): a(j) = 0, 8, 4, 12.
__host__ __device__ constexpr int col_shift(int j) {
  return j == 0 ? 0 : j == 1 ? 8 : j == 2 ? 4 : 12;
}

// Code of column J, sub-row S of word w (already XORed with the sign bits),
// times 2^(a(J) + BITS * S) for BITS < 8, exactly; for BITS = 8 the code.
template <int BITS, int J, int S>
__device__ __forceinline__ float code_f(unsigned w, unsigned w_hi,
                                        unsigned magic) {
  if constexpr (BITS == 8) {
    const unsigned bits = __byte_perm(w, magic, 0x7650u | J);
    return __uint_as_float(bits) - 8388736.0f;           // 2^23 + 128
  } else {
    constexpr int o = col_shift(J) + BITS * S;
    const unsigned src = J < 2 ? w : w_hi;
    const unsigned bits = and_or<((1u << BITS) - 1u) << o>(src, magic);
    return __uint_as_float(bits) -
           (8388608.0f + static_cast<float>((1u << (BITS - 1)) << o));
  }
}

template <int BITS>
__host__ __device__ constexpr unsigned sign_bits() {
  unsigned m = 0;
  for (int o = BITS - 1; o < 32; o += BITS) m |= 1u << o;
  return m;
}

template <int BITS, int MT>
struct Pipe {
  static constexpr int PER = 8 / BITS;
  static constexpr int XK = Shape<MT>::XK;
  static constexpr int SR = XK / PER;          // packed rows per x slice
  static constexpr int WR = SR / WARPS;        // ... per warp
  static constexpr int NIT = WR / D;           // stages per warp and slice
  static_assert(WR % D == 0 && NIT % 2 == 0, "stages come in pairs");
};

// D packed rows into buf, from p (row pr0, column c0) on in steps of N
// bytes; of them the first ``valid`` exist (0 past N), the rest read
// nothing and stay 0 (code 0 once the sign bits are flipped).
template <bool VEC>
__device__ __forceinline__ void load_stage(const int8_t* __restrict__ p,
                                           long long N, int valid, int ncols,
                                           unsigned (&buf)[D][W]) {
  if (valid >= D) {
#pragma unroll
    for (int i = 0; i < D; ++i, p += N) load_word<VEC>(p, ncols, buf[i]);
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i, p += N) {
      if (i < valid) {
        load_word<VEC>(p, ncols, buf[i]);
      } else {
#pragma unroll
        for (int v = 0; v < W; ++v) buf[i][v] = 0u;
      }
    }
  }
}

// Asks L2 for the warp's D rows from ``row`` on (BN bytes a row from
// column ``col`` on), one 32-byte sector a prefetch. Rows past ``rows`` and
// sectors past N are skipped.
__device__ __forceinline__ void prefetch_stage(const int8_t* __restrict__ packed,
                                               long long row, long long rows,
                                               int col, int N, int lane) {
  constexpr int SECTORS = BN / 32;
#pragma unroll
  for (int h = 0; h < D * SECTORS / 32; ++h) {
    const int idx = 32 * h + lane;
    const long long r = row + idx / SECTORS;
    const int sector = col + 32 * (idx % SECTORS);
    if (r < rows && sector < N) CK_PREFETCH(PACKED, packed + r * N + sector);
  }
}

// The M FMAs of column J, sub-row S of word V.
template <int BITS, int MT, int V, int J, int S>
__device__ __forceinline__ void fma_code(unsigned w, unsigned w_hi,
                                         unsigned magic, const float (&xv)[MT],
                                         float (&acc)[MT][COLS]) {
  const float q = code_f<BITS, J, S>(w, w_hi, magic);
#pragma unroll
  for (int r = 0; r < MT; ++r)
    acc[r][4 * V + J] = fmaf(xv[r], q, acc[r][4 * V + J]);
}

// The FMAs of word V's four columns at sub-row S.
template <int BITS, int MT, int V, int S>
__device__ __forceinline__ void fma_word(unsigned w, unsigned magic,
                                         const float (&xv)[MT],
                                         float (&acc)[MT][COLS]) {
  const unsigned w_hi = w >> 12;
  fma_code<BITS, MT, V, 0, S>(w, w_hi, magic, xv, acc);
  fma_code<BITS, MT, V, 1, S>(w, w_hi, magic, xv, acc);
  fma_code<BITS, MT, V, 2, S>(w, w_hi, magic, xv, acc);
  fma_code<BITS, MT, V, 3, S>(w, w_hi, magic, xv, acc);
}

// The FMAs of sub-rows S .. per-1 of one packed row's words (sign bits
// flipped); xk points at x of sub-row 0.
template <int BITS, int MT, int S = 0>
__device__ __forceinline__ void run_row(const unsigned (&w)[W], unsigned magic,
                                        const float* __restrict__ xk,
                                        float (&acc)[MT][COLS]) {
  float xv[MT];
#pragma unroll
  for (int r4 = 0; r4 < MT; r4 += 4) {
    const float4 v =
        CK_SH_LD(reinterpret_cast<const float4*>(xk + S * MT + r4));
    xv[r4] = v.x, xv[r4 + 1] = v.y, xv[r4 + 2] = v.z, xv[r4 + 3] = v.w;
  }
  fma_word<BITS, MT, 0, S>(w[0], magic, xv, acc);
  if constexpr (W == 2) fma_word<BITS, MT, 1, S>(w[1], magic, xv, acc);
  if constexpr (S + 1 < 8 / BITS) run_row<BITS, MT, S + 1>(w, magic, xk, acc);
}

// The FMAs of D packed rows whose first k (slice-local) is k0.
template <int BITS, int MT>
__device__ __forceinline__ void run_stage(const unsigned (&buf)[D][W],
                                          const float* __restrict__ xs, int k0,
                                          unsigned magic,
                                          float (&acc)[MT][COLS]) {
  constexpr int PER = 8 / BITS;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    unsigned w[W];
#pragma unroll
    for (int v = 0; v < W; ++v) w[v] = buf[i][v] ^ sign_bits<BITS>();
    run_row<BITS, MT>(w, magic, xs + (k0 + i * PER) * MT, acc);
  }
}

// x[k] * 2^-(BITS * (k mod per)), k slice-local: exact, see the header.
template <int BITS>
__device__ __forceinline__ float x_scale(int kk) {
  if constexpr (BITS == 8)
    return 1.0f;
  else
    return __uint_as_float((127u - BITS * (kk % (8 / BITS))) << 23);
}

// Rows row0 .. row0+MT-1 and k0 .. k0+XK-1 of x into xs, k-major and
// scaled by x_scale, zero past M and K. With ``xvec`` (K % 4 == 0 and x
// 16-byte aligned) a thread takes 4 rows x 4 k at a time: four 16-byte
// loads, all of a batch in flight together, transposed in registers into
// four 16-byte stores; else one element at a time.
template <int BITS, int MT, int XK>
__device__ __forceinline__ void stage_x(const float* __restrict__ x,
                                        float* __restrict__ xs, int M, int K,
                                        int row0, int k0, bool xvec) {
  if (xvec) {
    constexpr int KQ = XK / 4;                     // groups of 4 k a row
    constexpr int ITEMS = (MT / 4) * KQ / THREADS;   // per thread
    constexpr int BATCH = 2;
    static_assert(ITEMS % BATCH == 0, "whole batches");
#pragma unroll
    for (int i0 = 0; i0 < ITEMS; i0 += BATCH) {
      float4 v[BATCH][4];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int item = (i0 + b) * THREADS + threadIdx.x;
        const int gk = k0 + (item % KQ) * 4;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int gr = row0 + (item / KQ) * 4 + r;
          v[b][r] = (gr < M && gk < K)
                        ? CK_LDG(X, reinterpret_cast<const float4*>(
                                        x + static_cast<long long>(gr) * K +
                                        gk))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int item = (i0 + b) * THREADS + threadIdx.x;
        const int kk = (item % KQ) * 4, r0 = (item / KQ) * 4;
        const float f0 = x_scale<BITS>(kk), f1 = x_scale<BITS>(kk + 1),
                    f2 = x_scale<BITS>(kk + 2), f3 = x_scale<BITS>(kk + 3);
        CK_SH_ST(reinterpret_cast<float4*>(xs + kk * MT + r0),
                 make_float4(v[b][0].x * f0, v[b][1].x * f0, v[b][2].x * f0,
                             v[b][3].x * f0));
        CK_SH_ST(reinterpret_cast<float4*>(xs + (kk + 1) * MT + r0),
                 make_float4(v[b][0].y * f1, v[b][1].y * f1, v[b][2].y * f1,
                             v[b][3].y * f1));
        CK_SH_ST(reinterpret_cast<float4*>(xs + (kk + 2) * MT + r0),
                 make_float4(v[b][0].z * f2, v[b][1].z * f2, v[b][2].z * f2,
                             v[b][3].z * f2));
        CK_SH_ST(reinterpret_cast<float4*>(xs + (kk + 3) * MT + r0),
                 make_float4(v[b][0].w * f3, v[b][1].w * f3, v[b][2].w * f3,
                             v[b][3].w * f3));
      }
    }
  } else {
    for (int e = threadIdx.x; e < MT * XK; e += THREADS) {
      const int r = e / XK, kk = e % XK;
      const int gr = row0 + r, gk = k0 + kk;
      const float v =
          (gr < M && gk < K)
              ? CK_LD(X, x + (static_cast<long long>(gr) * K + gk))
              : 0.0f;
      CK_SH_ST(xs + (kk * MT + r), v * x_scale<BITS>(kk));
    }
  }
}

template <int BITS, int MT, bool VEC>
__global__ void __launch_bounds__(THREADS, Shape<MT>::MIN_BLOCKS)
    quant_matmul_kernel(const float* __restrict__ x,
                        const int8_t* __restrict__ packed,
                        const float* __restrict__ scales,
                        float* __restrict__ out, int M, int K, int N,
                        bool xvec, unsigned magic) {
  using Pp = Pipe<BITS, MT>;
  constexpr int PER = Pp::PER, XK = Pp::XK;
  static_assert(WARPS * MT * BN <= XK * MT, "the reduction fits x's slice");
  __shared__ __align__(16) float xs[XK * MT];
  CK_SHARED_ARRAY(xs, sizeof(xs));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * MT;
  const int c0 = col0 + lane * COLS;
  const long long rows = (static_cast<long long>(K) + PER - 1) / PER;
  const long long ldp = N;                // bytes from one packed row to the next
  const int ncols = N - c0;
  // this thread's rows from pr on that exist (none past N)
  auto valid = [&](long long pr) {
    return c0 < N ? static_cast<int>(max(0LL, min(static_cast<long long>(D),
                                                  rows - pr)))
                  : 0;
  };
  const int8_t* col = packed + c0;

  float acc[MT][COLS];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[r][j] = 0.0f;

  unsigned a[D][W], b[D][W];
  for (int k0 = 0; k0 < K; k0 += XK) {
    const long long pr0 = k0 / PER + warp * Pp::WR;   // this warp's first row
    load_stage<VEC>(col + pr0 * ldp, ldp, valid(pr0), ncols, a);
    for (int f = 1; f <= PF && f * D < Pp::WR; ++f)
      prefetch_stage(packed, pr0 + f * D, rows, col0, N, lane);
    if (k0 > 0) __syncthreads();          // every warp is done with xs
    stage_x<BITS, MT, XK>(x, xs, M, K, row0, k0, xvec);
    __syncthreads();
    const int kw = warp * Pp::WR * PER;   // this warp's first k in the slice
    // stage it + 1 goes to registers while stage it is summed, and the
    // stages PF beyond it to L2 (within this warp's share of the slice)
    const long long end = pr0 + Pp::WR;
    for (int it = 0; it < Pp::NIT; it += 2) {
      const long long pa = pr0 + it * D, pb = pa + D;
      if (pa >= rows) break;              // the rest of the slice is past K
      load_stage<VEC>(col + pb * ldp, ldp, valid(pb), ncols, b);
      if (pb + PF * D < end)
        prefetch_stage(packed, pb + PF * D, rows, col0, N, lane);
      run_stage<BITS, MT>(a, xs, kw + it * D * PER, magic, acc);
      if (pb >= rows) break;
      if (it + 2 < Pp::NIT) {
        load_stage<VEC>(col + (pb + D) * ldp, ldp, valid(pb + D), ncols, a);
        if (pb + (PF + 1) * D < end)
          prefetch_stage(packed, pb + (PF + 1) * D, rows, col0, N, lane);
      }
      run_stage<BITS, MT>(b, xs, kw + (it + 1) * D * PER, magic, acc);
    }
  }

  __syncthreads();                        // xs becomes the reduction buffer
  float* red = xs;                        // [WARPS][MT][BN]
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int v = 0; v < W; ++v)
      CK_SH_ST(reinterpret_cast<float4*>(
                   &red[(warp * MT + r) * BN + lane * COLS + 4 * v]),
               make_float4(acc[r][4 * v], acc[r][4 * v + 1],
                           acc[r][4 * v + 2], acc[r][4 * v + 3]));
  __syncthreads();
  for (int e = threadIdx.x; e < MT * BN; e += THREADS) {
    const int r = e / BN, cc = e % BN;
    const int gr = row0 + r, gc = col0 + cc;
    if (gr < M && gc < N) {
      float sum = CK_SH_LD(red + (r * BN + cc));
#pragma unroll
      for (int w = 1; w < WARPS; ++w)
        sum = __fadd_rn(sum,
                        CK_SH_LD(red + ((w * MT + r) * BN + cc)));
      if constexpr (BITS < 8)             // divide out 2^a(j), exactly
        sum = __fmul_rn(sum, __uint_as_float(
                                 (127u - col_shift(cc % 4)) << 23));
      CK_ST(OUT, out + (static_cast<long long>(gr) * N + gc),
            __fmul_rn(sum, CK_LD(SCALES, scales + gc)));
    }
  }
}

template <int BITS, int MT>
void launch_bits(const float* x, const int8_t* packed, const float* scales,
                 float* out, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + MT - 1) / MT);
  const bool xvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (N % COLS == 0 && reinterpret_cast<uintptr_t>(packed) % COLS == 0)
    quant_matmul_kernel<BITS, MT, true><<<grid, THREADS, 0, stream>>>(
        x, packed, scales, out, M, K, N, xvec, MAGIC);
  else
    quant_matmul_kernel<BITS, MT, false><<<grid, THREADS, 0, stream>>>(
        x, packed, scales, out, M, K, N, xvec, MAGIC);
}

// Rows of x a block: 4 up to the LM head's batch, else 8.
int rows_a_block(int M) { return M <= 4 ? 4 : 8; }

template <int MT>
cudaError_t launch(const float* x, const int8_t* packed, const float* scales,
                   float* out, int M, int K, int N, int bits,
                   cudaStream_t stream) {
  switch (bits) {
    case 2:
      launch_bits<2, MT>(x, packed, scales, out, M, K, N, stream);
      break;
    case 4:
      launch_bits<4, MT>(x, packed, scales, out, M, K, N, stream);
      break;
    case 8:
      launch_bits<8, MT>(x, packed, scales, out, M, K, N, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int BITS, int MT, bool VEC>
cudaError_t attributes(int* out) {
  return kernel_attributes::fill(quant_matmul_kernel<BITS, MT, VEC>,
                                 kernel_attributes::QUANT_MATMUL, BITS, MT,
                                 VEC, THREADS, 0, Shape<MT>::MIN_BLOCKS, out);
}

template <int BITS, int MT>
cudaError_t occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, quant_matmul_kernel<BITS, MT, true>, THREADS, 0);
}

}  // namespace

// x: (M, K) f32; packed: (ceil(K * bits / 8), N) int8; scales: (N,) f32;
// out: (M, N) f32. All contiguous, on the device. Returns
// cudaGetLastError() (cudaErrorInvalidValue for bits outside {2, 4, 8}).
extern "C" int repro_quant_matmul(const float* x, const int8_t* packed,
                                  const float* scales, float* out, int M,
                                  int K, int N, int bits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rows_a_block(M) == 4
          ? launch<4>(x, packed, scales, out, M, K, N, bits, s)
          : launch<8>(x, packed, scales, out, M, K, N, bits, s);
  return static_cast<int>(err);
}

// The launch of (M, N, bits) against the card: out = {its blocks, the blocks
// an SM holds by the runtime's occupancy calculator}. Returns a CUDA error
// (cudaErrorInvalidValue for bits outside {2, 4, 8}).
extern "C" int repro_quant_matmul_occupancy(int M, int N, int bits,
                                            int* out) {
  const int mt = rows_a_block(M);
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (mt == 4 && bits == 2) err = occupancy<2, 4>(&blocks);
  if (mt == 4 && bits == 4) err = occupancy<4, 4>(&blocks);
  if (mt == 4 && bits == 8) err = occupancy<8, 4>(&blocks);
  if (mt == 8 && bits == 2) err = occupancy<2, 8>(&blocks);
  if (mt == 8 && bits == 4) err = occupancy<4, 8>(&blocks);
  if (mt == 8 && bits == 8) err = occupancy<8, 8>(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = ((N + BN - 1) / BN) * ((M + mt - 1) / mt);
  out[1] = blocks;
  return 0;
}

// The records of kernel_attributes.cuh: every (bits, rows a block, vector
// loads) that repro_quant_matmul can launch, in that order.
cudaError_t kernel_attributes::quant_matmul(int i, int* out) {
  using A = cudaError_t (*)(int*);
  constexpr A records[] = {
      attributes<2, 4, true>,  attributes<2, 4, false>,
      attributes<2, 8, true>,  attributes<2, 8, false>,
      attributes<4, 4, true>,  attributes<4, 4, false>,
      attributes<4, 8, true>,  attributes<4, 8, false>,
      attributes<8, 4, true>,  attributes<8, 4, false>,
      attributes<8, 8, true>,  attributes<8, 8, false>};
  if (i < 0 || i >= static_cast<int>(sizeof(records) / sizeof(records[0])))
    return cudaErrorInvalidValue;
  return records[i](out);
}

// checked.cuh's hook of this source's kernel.
int ck::hooks::quant_matmul(const long long* table, int n, long long* record,
                            cudaStream_t stream) {
  return ck::hook(kernel_attributes::QUANT_MATMUL, table, n, record, stream);
}
