"""Registry of contract-check harnesses, one per SearchTarget architecture.

Port of the reference package's ``core/target_registry.py``. The contract
checker (``core/contracts.py``) verifies properties of the search hot
path on executed runs: banked forwards never requantize a weight, no
float64 appears in an eval, a generation is one dispatch, and population
lanes are independent (the serving tier uses the population axis as its
request axis). Those checks need a tiny but real instance of each target:
real params, real quantization tables, shapes small enough that a run is
instant. A ``ContractHarness`` packages exactly that, and this registry
maps architecture names to lazy harness factories, so a new target inherits
every check by registering one function.

Harness shape convention: every harness uses a time/sequence length of
``marker_dim`` (3) that appears in no other dimension of the model
(params, population, hidden sizes, menu). Activation fake-quant ops in the
forward therefore carry the marker dim in their operand shapes, while a
weight (re)quantization cannot: the checker tells the two apart from the
shapes alone.

Factories take ``device`` (default ``"cuda"``, as every entry point of the
port); on a card the harness's forwards run through the CUDA kernels.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Optional, Sequence

MARKER_DIM = 3


@dataclasses.dataclass
class ContractHarness:
    """Everything the contract checker needs for one architecture."""

    name: str
    target: Any                      # the SearchTarget instance
    feats: Any                       # tiny batch inputs (B, T=MARKER_DIM, ...)
    labels: Any
    layer_names: Sequence[str]       # quantizable layer order for allocations
    marker_dim: int                  # the unique activation-time dimension
    anchor_path: str                 # repo-relative file findings anchor to
    # forward_pop(params, feats, qp_stack, banks) -> population outputs;
    # banks=None must fall back to the requantizing lane (checker sanity).
    forward_pop: Callable[..., Any]
    # () -> a banked PopulationEvaluator for the dispatch checks
    make_evaluator: Callable[[], Any]
    supports_requant: bool = True
    # forward_decode(params, feats_lane, qp_stack, banks) -> (P, T, out):
    # the serving decode step, feats_lane (P, T, ...) one chunk per lane.
    # None = the architecture has no serving tier (it still gets C5 on
    # forward_pop).
    forward_decode: Optional[Callable[..., Any]] = None


_BUILTIN: Dict[str, str] = {
    "sru": "repro_torch.core.sru_experiment:sru_contract_harness",
    "xlstm": "repro_torch.core.xlstm_target:xlstm_contract_harness",
}
_CUSTOM: Dict[str, Callable[..., ContractHarness]] = {}


def register_contract_target(name: str,
                             make: Callable[..., ContractHarness]) -> None:
    """Register a harness factory (called with ``device=``) for a new
    architecture; the checker picks it up on its next run."""
    _CUSTOM[name] = make


def list_contract_targets() -> List[str]:
    return sorted(set(_BUILTIN) | set(_CUSTOM))


def get_contract_harness(name: str, device="cuda") -> ContractHarness:
    if name in _CUSTOM:
        return _CUSTOM[name](device=device)
    try:
        spec = _BUILTIN[name]
    except KeyError:
        raise KeyError(
            f"unknown contract target {name!r}; "
            f"known: {list_contract_targets()}") from None
    mod_name, func_name = spec.split(":")
    return getattr(importlib.import_module(mod_name), func_name)(
        device=device)
