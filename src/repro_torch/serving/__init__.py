"""Serving: the quantized-head LM decode and the Pareto-front server.

- ``lm``        greedy prefill and decode of a dense LM whose output head
                runs through the ``quant_matmul`` kernel;
- ``artifact``  loads a packed deployment once: the shared packed banks plus
                per-allocation menu-index/qp rows and objective rows;
- ``convert``   writes that artifact from a calibrated model;
- ``router``    maps each request's SLO class to an allocation on the front,
                with admission control and load-shed degradation;
- ``batcher``   continuous batching, one ``forward_decode_step`` dispatch
                per step: the population axis of the search is the request
                axis, so lane *i*'s menu index is request *i*'s allocation;
- ``metrics``   per-request latency decomposition and throughput.

Port of the reference package's ``serving`` (and of ``pack_deployment`` and
the LM half of ``examples/serve_quantized.py``). A chunk's served logits
equal the scalar ``forward(qp=)`` on the same frames: bitwise on the CPU,
where both run the plain PyTorch lane; within the matmul tolerance on a
card, where the served step runs the kernels.
"""
from repro_torch.serving.artifact import (DeploymentArtifact, alloc_cost_bits,
                                          load_deployment, qp_stack,
                                          serving_params)
from repro_torch.serving.batcher import (ContinuousBatcher, Request,
                                         SerialGroupBatcher, ServingEngine)
from repro_torch.serving.convert import pack_deployment
from repro_torch.serving.metrics import RequestRecord, ServingLog, StepRecord
from repro_torch.serving.router import (RouteDecision, Router, SLOClass,
                                        default_classes)

__all__ = [
    "ContinuousBatcher", "DeploymentArtifact", "Request", "RequestRecord",
    "RouteDecision", "Router", "SLOClass", "SerialGroupBatcher",
    "ServingEngine", "ServingLog", "StepRecord", "alloc_cost_bits",
    "default_classes", "load_deployment", "pack_deployment", "qp_stack",
    "serving_params",
]
