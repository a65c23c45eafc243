"""Parallel-scan primitives for h_t = a_t * h_{t-1} + b_t
(``repro.core.scan``).

Every minGRU / minLSTM layer reduces to this elementwise first-order
linear recurrence, which is associative under

    (a_i, b_i) o (a_j, b_j) = (a_i * a_j, a_j * b_i + b_j)   (i before j)

Strategies (the reference's names):

  * ``scan_sequential``  -- a Python loop over T; ground truth
  * ``scan_associative`` -- a Hillis-Steele doubling ladder over T (torch
                            has no ``associative_scan``): log2(T) rounds of
                            whole-tensor shift / multiply-add
  * ``scan_log_space``   -- the Heinsen (2023) log-space scan
  * ``scan_chunked``     -- two-level: doubling ladder inside chunks, a
                            sequential carry across them
  * ``"pallas"``         -- the hand-written CUDA scans
                            (``kernels/scan/ops.py``)
  * ``scan_sequence_parallel`` -- the time axis split over the ranks of a
                            ``torch.distributed`` group

Array convention: time axis ``axis`` (default -2), shapes ``(..., T, D)``;
``h0`` is ``(..., D)``.
"""

from __future__ import annotations

from typing import Optional

import torch

# "fused" = the fused projection + scan kernels (minGRU / minLSTM layers
# only; resolved by the cell's ``parallel``); "auto" resolves to it.
STRATEGIES = ("associative", "sequential", "chunked", "pallas", "fused",
              "auto")


def resolve_strategy(strategy: str) -> str:
    """Resolve the config-level ``scan_strategy`` to a concrete strategy."""
    if strategy == "auto":
        return "fused"
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown scan strategy {strategy!r}")
    return strategy


def combine(left, right):
    """Associative combine for h_t = a_t h_{t-1} + b_t segments."""
    a_l, b_l = left
    a_r, b_r = right
    return a_l * a_r, a_r * b_l + b_r


def scan_sequential(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None,
                    axis: int = -2) -> torch.Tensor:
    """O(T) loop. Ground truth for every other strategy."""
    a = a.movedim(axis, 0)
    b = b.movedim(axis, 0)
    h = torch.zeros_like(b[0]) if h0 is None else h0
    hs = []
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        hs.append(h)
    return torch.stack(hs).movedim(0, axis)


def _shift(x: torch.Tensor, shift: int, fill: float) -> torch.Tensor:
    """x shifted ``shift`` places later along dim -2, ``fill`` in front."""
    pad = torch.full(x.shape[:-2] + (shift, x.shape[-1]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-shift, :]], dim=-2)


def _doubling(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) segments along dim -2: returns the
    cumulative (A, B) with h_t = B_t + A_t h_{-1}."""
    shift = 1
    while shift < a.shape[-2]:
        a, b = combine((_shift(a, shift, 1.0), _shift(b, shift, 0.0)),
                       (a, b))
        shift *= 2
    return a, b


def scan_associative_with_aggregate(a: torch.Tensor, b: torch.Tensor,
                                    axis: int = -2):
    """The cumulative coefficients and values (A_t, B_t)."""
    a_cum, b_cum = _doubling(a.movedim(axis, -2), b.movedim(axis, -2))
    return a_cum.movedim(-2, axis), b_cum.movedim(-2, axis)


def scan_associative(a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None,
                     axis: int = -2) -> torch.Tensor:
    """Parallel scan by the doubling ladder."""
    a_cum, b_cum = scan_associative_with_aggregate(a, b, axis=axis)
    if h0 is None:
        return b_cum
    return b_cum + a_cum * h0.unsqueeze(axis)


def scan_sequence_parallel(a: torch.Tensor, b: torch.Tensor, group,
                           h0: Optional[torch.Tensor] = None,
                           axis: int = -2) -> torch.Tensor:
    """A scan whose time axis is split over the ranks of ``group`` (a
    ``torch.distributed`` process group, None for a group of one), in
    group-rank order: ``a`` / ``b`` are this rank's block of the
    sequence, ``h0`` the state before the whole sequence.  The
    reference's steps:

      1. a local inclusive scan -> (A_loc, B_loc);
      2. an all-gather of every rank's aggregate (its last element), 2 D
         values a row per rank -- the only collective;
      3. the aggregates of the ranks before this one combined in order
         onto ``h0`` (zero without it): this rank's incoming carry;
      4. the fix-up h = B_loc + A_loc * carry_in.

    Differentiable: the gather's backward sums the cotangents of this
    rank's aggregate over the group (a collective: every rank of the
    group runs the backward)."""
    from repro_torch.distributed import collectives
    a_cum, b_cum = scan_associative_with_aggregate(a, b, axis=axis)
    last = a_cum.shape[axis] - 1
    agg = torch.stack([a_cum.narrow(axis, last, 1),
                       b_cum.narrow(axis, last, 1)])     # (2, ..., 1, D)
    every = collectives.all_gather(agg, group)           # (n, 2, ..., 1, D)
    carry = torch.zeros_like(agg[1])
    if h0 is not None:
        carry = carry + h0.unsqueeze(axis).to(b.dtype)
    # the carry before every rank, as the reference's scan over the ranks
    # gives them: every rank's graph then holds the gather, so every rank
    # joins its backward's all-reduce
    carries = [carry]
    for k in range(every.shape[0] - 1):
        carries.append(every[k, 0] * carries[-1] + every[k, 1])
    carry_in = torch.stack(carries)[collectives.rank_in(group)]
    return b_cum + a_cum * carry_in


def logcumsumexp(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Cumulative logsumexp by the doubling ladder of ``logaddexp``
    (which gives -inf for two -inf inputs, as ``jnp.logaddexp`` does)."""
    x = x.movedim(axis, -2)
    shift = 1
    while shift < x.shape[-2]:
        x = torch.logaddexp(_shift(x, shift, float("-inf")), x)
        shift *= 2
    return x.movedim(-2, axis)


def scan_log_space(log_a: torch.Tensor, log_b: torch.Tensor,
                   log_h0: Optional[torch.Tensor] = None, axis: int = -2,
                   strategy: str = "associative") -> torch.Tensor:
    """Heinsen scan: inputs are log coefficients / log values, output is h.

    h_t = exp(a*_t + logcumsumexp(log_b - a*)_t)  with a*_t = cumsum(log_a).
    A given ``log_h0`` is prepended exactly, as the paper's
    ``torch.cat([log_h0, ...])`` does.  ``strategy="pallas"`` runs the CUDA
    log-space scan (``kernels/scan/ops.log_space_scan_auto``)."""
    if strategy == "pallas":
        from repro_torch.kernels.scan import ops as scan_kernel_ops
        if axis not in (-2, log_a.ndim - 2):
            raise ValueError("pallas log scan requires time axis -2")
        return scan_kernel_ops.log_space_scan_auto(log_a, log_b, log_h0)
    if log_h0 is not None:
        zero = torch.zeros_like(log_a.narrow(axis, 0, 1))
        log_a_ext = torch.cat([zero, log_a], dim=axis)
        log_b_ext = torch.cat([log_h0.unsqueeze(axis), log_b], dim=axis)
        h = scan_log_space(log_a_ext, log_b_ext, None, axis=axis)
        return h.narrow(axis, 1, h.shape[axis] - 1)    # drop the h0 slot
    a_star = torch.cumsum(log_a, dim=axis)
    log_h = a_star + logcumsumexp(log_b - a_star, axis=axis)
    return torch.exp(log_h)


def scan_chunked(a: torch.Tensor, b: torch.Tensor,
                 h0: Optional[torch.Tensor] = None, chunk: int = 256,
                 axis: int = -2) -> torch.Tensor:
    """Two-level scan: intra-chunk parallel, inter-chunk sequential."""
    a = a.movedim(axis, -2)
    b = b.movedim(axis, -2)
    lead = a.shape[:-2]
    t, d = a.shape[-2], a.shape[-1]
    if t % chunk:
        pad = chunk - t % chunk             # identity elements (1, 0)
        a = torch.cat([a, a.new_ones(lead + (pad, d))], dim=-2)
        b = torch.cat([b, b.new_zeros(lead + (pad, d))], dim=-2)
    nc = a.shape[-2] // chunk
    a_cum, b_cum = _doubling(a.reshape(lead + (nc, chunk, d)),
                             b.reshape(lead + (nc, chunk, d)))
    h = b.new_zeros(lead + (d,)) if h0 is None else h0.to(b.dtype)
    carries = []
    for k in range(nc):               # the carry before each chunk
        carries.append(h)
        h = a_cum[..., k, -1, :] * h + b_cum[..., k, -1, :]
    carries = torch.stack(carries, dim=-2)             # (..., nc, d)
    out = b_cum + a_cum * carries[..., :, None, :]
    out = out.reshape(lead + (nc * chunk, d))[..., :t, :]
    return out.movedim(-2, axis)


def scan_linear(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None, axis: int = -2,
                strategy: str = "associative",
                chunk: int = 256) -> torch.Tensor:
    """Unified entry point used by the model layers."""
    if strategy == "associative":
        return scan_associative(a, b, h0, axis=axis)
    if strategy == "sequential":
        return scan_sequential(a, b, h0, axis=axis)
    if strategy == "chunked":
        return scan_chunked(a, b, h0, chunk=chunk, axis=axis)
    if strategy == "pallas":
        from repro_torch.kernels.scan import ops as scan_kernel_ops
        if axis not in (-2, a.ndim - 2):
            raise ValueError("pallas scan requires time axis -2")
        return scan_kernel_ops.linear_scan_auto(a, b, h0)
    raise ValueError(f"unknown scan strategy {strategy!r}")
