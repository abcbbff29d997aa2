// The one C entry of the kernel verifier's rule K3: every kernel
// instantiation the sources can launch, numbered, with what the card holds
// of it (kernel_attributes.cuh).
#include <cuda_runtime.h>

#include "kernel_attributes.cuh"

// Record `which` (0, 1, ...) into out[0 .. kernel_attributes::FIELDS): the
// bank_mxv_pop instantiations first, then bank_qmm_pop's, quant_matmul's
// and sru_scan_pop's. Returns cudaErrorInvalidValue past the last record,
// else the CUDA error of reading the attributes.
extern "C" int repro_kernel_attributes(int which, int* out) {
  using F = cudaError_t (*)(int, int*);
  const F sources[] = {kernel_attributes::bank_mxv_pop,
                       kernel_attributes::bank_qmm_pop,
                       kernel_attributes::quant_matmul,
                       kernel_attributes::sru_scan_pop};
  for (F source : sources) {
    for (int i = 0;; ++i, --which) {
      const cudaError_t err = source(i, out);
      if (err == cudaErrorInvalidValue) break;  // past this source's last
      if (which == 0) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
