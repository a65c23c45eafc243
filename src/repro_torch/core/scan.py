"""Scan strategy names (``repro.core.scan`` dispatch subset).

The parallel scans are training-path code and come with a later slice;
the serving slice only needs the strategy resolution that picks between
the fused kernels and the plain sequential oracle.
"""

from __future__ import annotations

# "fused" = the hand-written kernels; "auto" resolves to it.  The other
# names are the reference's pure-array strategies: for decode they all
# run the plain PyTorch step.
STRATEGIES = ("associative", "sequential", "chunked", "pallas", "fused",
              "auto")


def resolve_strategy(strategy: str) -> str:
    """Resolve the config-level ``scan_strategy`` to a concrete strategy."""
    if strategy == "auto":
        return "fused"
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown scan strategy {strategy!r}")
    return strategy
