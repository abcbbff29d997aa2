// The accessor layer of the kernels' memory accesses: every global and
// shared access of csrc/*.cu* goes through one of the CK_ macros below
// (the kernel verifier's static rule K2, analysis/kernel_rules.py, holds
// that line by line).
//
// Without REPRO_CHECKED each macro expands to the expression it wraps, so
// the default library compiles to the same code as the accesses written
// out. With REPRO_CHECKED (kernels/build.py's checked build) each access
// checks its bytes against an extent before it happens:
// - a global access against its pointer parameter's extent: before each
//   launch the wrapper passes, through repro_checked_extents (checked.cu),
//   the base address and bytes of each pointer parameter of the C entry,
//   in the entry's order (each source's `enum Param`), read off the tensors;
// - a shared access against the block's shared array, named at block entry
//   by CK_SHARED_ARRAY, which also fills it with NaN: a read of a word
//   that nothing wrote then shows as NaN in the output.
// A violation adds one to the source's counter, the first one of a launch
// is recorded with atomicCAS (kernel, file:line, parameter, offset, extent,
// block, thread), and the access is dropped: a load gives NaN (0x7fc00000
// in every 4-byte word), a store or a copy does nothing (a copy whose
// source is out of range stores NaN into its shared destination). There is
// no assert and no trap: either leaves the CUDA context in a sticky error
// for the rest of the process, and the verifier runs inside other work.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>

namespace ck {

constexpr int MAX_PARAMS = 12;  // pointer parameters of a C entry
constexpr int UNCHECKED = -1;   // what the hooks return in the default build
// A record, in long longs: violations, kernel (kernel_attributes.cuh's id),
// line, parameter (its index in the C entry; -1: the shared array), offset
// and width of the access in bytes, the extent in bytes, the parameter's
// element bytes, block x, y, z, thread, and the file (file_id of its name).
constexpr int RECORD = 13;

// 32-bit FNV-1a of the file name after the last '/', at compile time: the
// record's file (analysis/kernel_rules.py hashes the sources' names alike).
__host__ __device__ constexpr unsigned file_id(const char* path) {
  const char* name = path;
  for (const char* p = path; *p; ++p)
    if (*p == '/') name = p + 1;
  unsigned h = 2166136261u;
  for (; *name; ++name)
    h = (h ^ static_cast<unsigned char>(*name)) * 16777619u;
  return h;
}

template <unsigned V>
struct Id {
  static constexpr unsigned value = V;
};

// The host side of a source file's checked state: `table` (n triples of
// base address, bytes, element bytes) becomes the extents of the next
// launch on `stream`; a non-null `record` receives the record and the
// state is cleared. Each kernel source defines its own (its own device
// module holds its own state), kernel_attributes-style.
namespace hooks {
int bank_mxv_pop(const long long* table, int n, long long* record,
                 cudaStream_t stream);
int bank_qmm_pop(const long long* table, int n, long long* record,
                 cudaStream_t stream);
int quant_matmul(const long long* table, int n, long long* record,
                 cudaStream_t stream);
int sru_scan_pop(const long long* table, int n, long long* record,
                 cudaStream_t stream);
}  // namespace hooks

namespace {

#ifdef REPRO_CHECKED

struct Extent {
  unsigned long long base, bytes, itemsize;
};

struct State {
  Extent ext[MAX_PARAMS];
  unsigned long long count;
  unsigned int claimed;
  long long rec[RECORD];
};

__device__ State state;                // this source file's
__shared__ const char* shared_base;    // the block's shared array
__shared__ unsigned int shared_bytes;

// Counts a violation and records the launch's first (out of line: each
// check's cold path is one call; inlined, the checked build compiles ~1.5x
// slower).
__device__ __noinline__ void violation(int param, long long offset,
                                          int width, unsigned file,
                                          int line) {
  atomicAdd(&state.count, 1ull);
  if (atomicCAS(&state.claimed, 0u, 1u) != 0u) return;
  long long* r = state.rec;
  r[2] = line;
  r[3] = param;
  r[4] = offset;
  r[5] = width;
  r[6] = param < 0 ? shared_bytes
                   : static_cast<long long>(state.ext[param].bytes);
  r[7] = param < 0 ? 4 : static_cast<long long>(state.ext[param].itemsize);
  r[8] = blockIdx.x;
  r[9] = blockIdx.y;
  r[10] = blockIdx.z;
  r[11] = threadIdx.x;
  r[12] = file;
  __threadfence();
}

// Is [p, p + width) inside parameter `param`'s extent? Records it if not.
__device__ __forceinline__ bool in_param(int param, const void* p, int width,
                                         unsigned file, int line) {
  const long long off = static_cast<long long>(
      reinterpret_cast<unsigned long long>(p) - state.ext[param].base);
  if (off >= 0 &&
      off + width <= static_cast<long long>(state.ext[param].bytes))
    return true;
  violation(param, off, width, file, line);
  return false;
}

__device__ __forceinline__ bool in_shared(const void* p, int width,
                                          unsigned file, int line) {
  const long long off = static_cast<const char*>(p) - shared_base;
  if (off >= 0 && off + width <= shared_bytes) return true;
  violation(-1, off, width, file, line);
  return false;
}

template <class P>
__device__ __forceinline__ P nan_of() {
  constexpr unsigned NAN_BITS = 0x7fc00000u;
  P v;
  unsigned char* b = reinterpret_cast<unsigned char*>(&v);
  for (int i = 0; i < static_cast<int>(sizeof(P)); ++i)
    b[i] = static_cast<unsigned char>(NAN_BITS >> (8 * (i % 4)));
  return v;
}

template <class P>
__device__ __forceinline__ P ld(int param, const P* p, unsigned file,
                                int line) {
  return in_param(param, p, sizeof(P), file, line) ? *p : nan_of<P>();
}

template <class P>
__device__ __forceinline__ P ldg(int param, const P* p, unsigned file,
                                 int line) {
  return in_param(param, p, sizeof(P), file, line) ? __ldg(p) : nan_of<P>();
}

template <class P, class V>
__device__ __forceinline__ void st(int param, P* p, const V& v,
                                   unsigned file, int line) {
  if (in_param(param, p, sizeof(P), file, line)) *p = v;
}

template <class P>
__device__ __forceinline__ P sh_ld(const P* p, unsigned file, int line) {
  return in_shared(p, sizeof(P), file, line) ? *p : nan_of<P>();
}

template <class P, class V>
__device__ __forceinline__ void sh_st(P* p, const V& v, unsigned file,
                                      int line) {
  if (in_shared(p, sizeof(P), file, line)) *p = v;
}

// A W-byte copy into shared `dst` from `src` (src_bytes of it, 0 or W):
// the destination must lie in the shared array and the source, even a
// zero-byte copy's, in its parameter. Returns whether to issue it.
template <int W>
__device__ __forceinline__ bool copy_ok(int param, void* dst, const void* src,
                                        int src_bytes, unsigned file,
                                        int line) {
  if (!in_shared(dst, W, file, line)) return false;
  if (in_param(param, src, src_bytes > 0 ? src_bytes : 1, file, line))
    return true;
  for (int i = 0; i < W / 4; ++i)
    static_cast<float*>(dst)[i] = __int_as_float(0x7fc00000);
  return false;
}

// Names the block's shared array and fills it with NaN; every thread of
// the block calls it, before any other shared access.
__device__ __forceinline__ void shared_array(void* p, unsigned int bytes) {
  if (threadIdx.x == 0) {
    shared_base = static_cast<const char*>(p);
    shared_bytes = bytes;
  }
  for (unsigned int i = threadIdx.x; i < bytes / 4; i += blockDim.x)
    static_cast<unsigned int*>(p)[i] = 0x7fc00000u;
  __syncthreads();
}

// Fills n floats of a ring slot with NaN (its last reader has passed a
// barrier, its next copy is not issued yet).
__device__ __forceinline__ void poison(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    p[i] = __int_as_float(0x7fc00000);
}

inline int hook(int kernel, const long long* table, int n, long long* record,
                cudaStream_t stream) {
  if (table) {
    if (n < 0 || n > MAX_PARAMS) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaMemcpyToSymbolAsync(
        state, table, n * sizeof(Extent), offsetof(State, ext),
        cudaMemcpyHostToDevice, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (record) {
    State host{};
    cudaError_t err = cudaDeviceSynchronize();
    if (err == cudaSuccess)
      err = cudaMemcpyFromSymbol(&host, state, sizeof(State));
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int i = 0; i < RECORD; ++i) record[i] = host.rec[i];
    record[0] = static_cast<long long>(host.count);
    record[1] = kernel;
    host = State{};
    err = cudaMemcpyToSymbol(state, &host, sizeof(State));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

#else

inline int hook(int, const long long*, int, long long*, cudaStream_t) {
  return UNCHECKED;
}

#endif  // REPRO_CHECKED

}  // namespace
}  // namespace ck

#ifdef REPRO_CHECKED
// where an access is written: its file's id and line
#define CK_AT ck::Id<ck::file_id(__FILE__)>::value, __LINE__
#define CK_LD(param, p) ck::ld(param, p, CK_AT)
#define CK_LDG(param, p) ck::ldg(param, p, CK_AT)
#define CK_ST(param, p, v) ck::st(param, p, v, CK_AT)
#define CK_SH_LD(p) ck::sh_ld(p, CK_AT)
#define CK_SH_ST(p, v) ck::sh_st(p, v, CK_AT)
#define CK_CP_ASYNC(W, param, dst, src, bytes)                     \
  do {                                                             \
    if (ck::copy_ok<W>(param, dst, src, bytes, CK_AT))             \
      cp_async<W>(dst, src, bytes);                                \
  } while (0)
#define CK_PREFETCH(param, p)                                      \
  do {                                                             \
    if (ck::in_param(param, p, 1, CK_AT))                          \
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p));           \
  } while (0)
#define CK_SHARED_ARRAY(p, bytes) ck::shared_array(p, bytes)
#else
#define CK_LD(param, p) (*(p))
#define CK_LDG(param, p) __ldg(p)
#define CK_ST(param, p, v) (*(p) = (v))
#define CK_SH_LD(p) (*(p))
#define CK_SH_ST(p, v) (*(p) = (v))
#define CK_CP_ASYNC(W, param, dst, src, bytes) cp_async<W>(dst, src, bytes)
#define CK_PREFETCH(param, p) \
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p))
#define CK_SHARED_ARRAY(p, bytes) ((void)0)
#endif
