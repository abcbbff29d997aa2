"""PyTorch and CUDA port of the MOHAQ system (the JAX package ``repro`` is
the reference it is tested against). Importing it imports no JAX and
nothing of ``repro``; its CUDA kernels build at first use, not at import.

Layout mirrors ``repro``: ``core/`` (quantization, population evaluator,
NSGA-II search, the SRU and xLSTM search targets, durable files),
``configs/``, ``models/`` (the SRU, the dense LM, the xLSTM), ``kernels/`` (plain versions,
wrappers, build) with the CUDA sources in ``csrc/``, ``serving/`` (the
quantized-head LM decode and the Pareto-front server) and
``data/synthetic.py``."""
