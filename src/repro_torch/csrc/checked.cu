// The C entries of the checked build (checked.cuh): the extents of a
// launch's pointer parameters, and the record of its violations. Both
// exist in the default build too, where they return ck::UNCHECKED, so
// that the library's prototypes do not depend on the build.
#include <cuda_runtime.h>

#include "checked.cuh"
#include "kernel_attributes.cuh"

namespace {

using Hook = int (*)(const long long*, int, long long*, cudaStream_t);

// by kernel_attributes.cuh's kernel id
constexpr Hook HOOKS[] = {ck::hooks::bank_mxv_pop, ck::hooks::bank_qmm_pop,
                          ck::hooks::quant_matmul, ck::hooks::sru_scan_pop};
constexpr int KERNELS = sizeof(HOOKS) / sizeof(HOOKS[0]);

}  // namespace

// Before a launch of kernel `kernel` (kernel_attributes.cuh's id) on
// `stream`: table holds n triples (base address, bytes, element bytes), one
// a pointer parameter of the kernel's C entry in order. Returns a CUDA
// error, or ck::UNCHECKED in the default build.
extern "C" int repro_checked_extents(int kernel, const long long* table,
                                     int n, void* stream) {
  if (kernel < 0 || kernel >= KERNELS)
    return static_cast<int>(cudaErrorInvalidValue);
  return HOOKS[kernel](table, n, nullptr, static_cast<cudaStream_t>(stream));
}

// Waits for the device, then writes into out[0 .. ck::RECORD) the
// violations counted since the last call, summed over the kernels, and the
// first recorded one (checked.cuh's layout; out[0] = 0: none), and clears
// them. Returns a CUDA error, or ck::UNCHECKED in the default build.
extern "C" int repro_checked_report(long long* out) {
  long long total = 0, rec[ck::RECORD];
  for (int i = 0; i < ck::RECORD; ++i) out[i] = 0;
  for (int k = 0; k < KERNELS; ++k) {
    const int err = HOOKS[k](nullptr, 0, rec, nullptr);
    if (err != 0) return err;
    if (rec[0] > 0 && total == 0)
      for (int i = 0; i < ck::RECORD; ++i) out[i] = rec[i];
    total += rec[0];
  }
  out[0] = total;
  return 0;
}
