"""Static and driven checks of the port's CUDA kernels: the kernel
verifier (``kernel_rules.py``, rules K0-K4), run by ``python -m
repro_torch.analysis`` and by ``chip_smoke.py``'s ``kernel_rules``
phase."""
from repro_torch.analysis.kernel_rules import Finding, run_kernel_checks

__all__ = ["Finding", "run_kernel_checks"]
