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
// What bounds it on an H100: bytes. On the serving path (the LM head of
// stablelm-1.6b) M is the batch (4), K = 2048 and N = 100352: the int8
// container is 205.5 MB and the FMAs 1.64 GFLOP, so the product is a GEMV,
// 0.062 ms at 3.35 TB/s against 0.025 ms at 67 TFLOP/s fp32.
//
// Design: each block owns 128 columns and up to MT rows of x (MT = 4 when
// M <= 4, else 8; x is staged in shared memory). A thread owns 4 adjacent
// columns and reads one 4-byte word per packed row, so a warp reads 128
// consecutive bytes of a row. The block's 8 warps split K: of each chunk of
// 256 K rows, warp w takes rows [32w, 32w + 32). It issues all its word
// loads for the chunk first (up to 32 in flight per thread, which is what
// keeps enough bytes in flight to approach the memory rate), then unpacks,
// dequantizes each code with __fmul_rn(code, scale[c]) before its FMA (the
// scale is not factored out of the sum, as in the TPU kernel), and
// accumulates in registers. At the end the 8 warps' partial sums are added
// in warp order through shared memory, so every output has one fixed
// summation order. Ragged M, N and K are masked here: codes past K (the
// padding of the last packed byte) are never used, and the wrapper pads
// nothing. No tensor cores: fp32 FMA on the CUDA cores, held to the plain
// f32 matmul at rtol 1e-4 / atol 1e-3.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 4;            // adjacent columns per thread
constexpr int BN = 32 * COLS;      // 128 columns per block
constexpr int KW = 32;             // K rows per warp per chunk
constexpr int KC = WARPS * KW;     // 256 K rows per chunk

// Field `sub` of byte `j` of `word`, sign-extended.
template <int BITS>
__device__ __forceinline__ int decode(unsigned word, int j, int sub) {
  const unsigned byte = (word >> (8 * j)) & 0xFFu;
  if (BITS == 8) return static_cast<int>(static_cast<int8_t>(byte));
  const unsigned v = (byte >> (sub * BITS)) & ((1u << BITS) - 1u);
  return static_cast<int>(v) - ((v & (1u << (BITS - 1))) ? (1 << BITS) : 0);
}

// Bytes c0 .. c0+3 of packed row r as one little-endian word, zero past N.
__device__ __forceinline__ unsigned load_word(const int8_t* __restrict__ packed,
                                              long long r, int c0, int N,
                                              bool vec) {
  const int8_t* p = packed + r * N + c0;
  if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  unsigned w = 0;
#pragma unroll
  for (int j = 0; j < COLS; ++j)
    if (c0 + j < N) w |= static_cast<unsigned>(static_cast<uint8_t>(p[j])) << (8 * j);
  return w;
}

template <int BITS, int MT>
__global__ void __launch_bounds__(THREADS)
    quant_matmul_kernel(const float* __restrict__ x,
                        const int8_t* __restrict__ packed,
                        const float* __restrict__ scales,
                        float* __restrict__ out, int M, int K, int N,
                        bool vec) {
  constexpr int PER = 8 / BITS;
  constexpr int RW = KW / PER;  // packed rows per warp per chunk
  __shared__ __align__(16) float xs[MT][KC];
  __shared__ __align__(16) float red[WARPS][MT][BN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * MT;
  const int c0 = col0 + lane * COLS;

  float s[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) s[j] = (c0 + j < N) ? scales[c0 + j] : 0.0f;
  float acc[MT][COLS];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[r][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int e = threadIdx.x; e < MT * KC; e += THREADS) {
      const int r = e / KC, kk = e % KC;
      const int gr = row0 + r, gk = k0 + kk;
      xs[r][kk] = (gr < M && gk < K) ? x[static_cast<long long>(gr) * K + gk]
                                     : 0.0f;
    }
    __syncthreads();
    const int kw = warp * KW;  // this warp's first row within the chunk
    if (k0 + kw < K && c0 < N) {
      unsigned words[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int pr = (k0 + kw) / PER + i;
        words[i] = (pr * PER < K) ? load_word(packed, pr, c0, N, vec) : 0u;
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
#pragma unroll
        for (int sub = 0; sub < PER; ++sub) {
          const int kk = kw + i * PER + sub;
          if (k0 + kk < K) {
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
              const float w = __fmul_rn(
                  static_cast<float>(decode<BITS>(words[i], j, sub)), s[j]);
#pragma unroll
              for (int r = 0; r < MT; ++r)
                acc[r][j] = fmaf(xs[r][kk], w, acc[r][j]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < MT; ++r)
    *reinterpret_cast<float4*>(&red[warp][r][lane * COLS]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int e = threadIdx.x; e < MT * BN; e += THREADS) {
    const int r = e / BN, cc = e % BN;
    const int gr = row0 + r, gc = col0 + cc;
    if (gr < M && gc < N) {
      float sum = red[0][r][cc];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) sum = __fadd_rn(sum, red[w][r][cc]);
      out[static_cast<long long>(gr) * N + gc] = sum;
    }
  }
}

template <int MT>
cudaError_t launch(const float* x, const int8_t* packed, const float* scales,
                   float* out, int M, int K, int N, int bits,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + MT - 1) / MT);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 4 == 0;
  switch (bits) {
    case 2:
      quant_matmul_kernel<2, MT><<<grid, THREADS, 0, stream>>>(
          x, packed, scales, out, M, K, N, vec);
      break;
    case 4:
      quant_matmul_kernel<4, MT><<<grid, THREADS, 0, stream>>>(
          x, packed, scales, out, M, K, N, vec);
      break;
    case 8:
      quant_matmul_kernel<8, MT><<<grid, THREADS, 0, stream>>>(
          x, packed, scales, out, M, K, N, vec);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) f32; packed: (ceil(K * bits / 8), N) int8; scales: (N,) f32;
// out: (M, N) f32. All contiguous, on the device. Returns cudaGetLastError()
// (cudaErrorInvalidValue for bits outside {2, 4, 8}).
extern "C" int repro_quant_matmul(const float* x, const int8_t* packed,
                                  const float* scales, float* out, int M,
                                  int K, int N, int bits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      M <= 4 ? launch<4>(x, packed, scales, out, M, K, N, bits, s)
             : launch<8>(x, packed, scales, out, M, K, N, bits, s);
  return static_cast<int>(err);
}
