"""Plain PyTorch versions of the scan kernels (``csrc/scan.cu``).

``linear_scan_ref`` / ``log_scan_ref`` follow
``repro.kernels.scan.ref.linear_scan_ref`` -- a sequential walk over T --
with an fp32 carry, the output rounded to ``b``'s dtype (linear) or left
in fp32 (log space).  The CPU path of every wrapper in ``ops.py`` runs
these; on a card they are what ``chip_smoke.py`` holds the kernels
against.  "fp32" means at least fp32: float64 inputs stay float64, so a
float64 gradcheck can run through them.

``linear_scan_segmented`` / ``log_scan_segmented`` render the kernels'
own order in PyTorch ops: T in tiles of ``WARPS`` segments of ``SEG``
steps (a ragged tile padded with the identity, which changes no bit), a
local scan of each segment, the ordered fold of the earlier segments'
aggregates onto the tile's carry, the fix-up.  They are the
specification of ``csrc/scan.cu``'s arithmetic, not a path of the port:
on the card the kernels equal them bit for bit.

``inputs`` makes the seeded operands that the card's checks and timings
hold the kernels to.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# csrc/scan.cu's kSeg and kWarps: steps a warp owns, segments a T-tile
SEG, WARPS = 32, 8


def wide(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype for ``dtype``: fp32, or fp64 for fp64."""
    return torch.promote_types(dtype, torch.float32)


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over dim -2 (reversed: t = T-1 .. 0 with
    h_t = a_t * h_{t+1} + b_t).  a, b: (B, T, D); h0: (B, D)."""
    acc = wide(b.dtype)
    h = h0.to(acc)
    order = range(a.shape[-2] - 1, -1, -1) if reverse else \
        range(a.shape[-2])
    hs = [None] * a.shape[-2]
    for t in order:
        h = a[..., t, :].to(acc) * h + b[..., t, :].to(acc)
        hs[t] = h
    return torch.stack(hs, dim=-2).to(b.dtype)


def log_scan_ref(log_a: torch.Tensor, log_b: torch.Tensor,
                 log_h0: torch.Tensor) -> torch.Tensor:
    """log_h_t = logaddexp(log_a_t + log_h_{t-1}, log_b_t); returns
    exp(log_h) in fp32.  ``log_h0`` = -inf encodes h0 = 0, and
    ``torch.logaddexp(-inf, -inf)`` is -inf, as the kernel's."""
    acc = wide(log_b.dtype)
    lh = log_h0.to(acc)
    hs = []
    for t in range(log_a.shape[-2]):
        lh = torch.logaddexp(log_a[..., t, :].to(acc) + lh,
                             log_b[..., t, :].to(acc))
        hs.append(torch.exp(lh))
    return torch.stack(hs, dim=-2)


def logaddexp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernels' logaddexp: max first, so (-inf, -inf) gives -inf."""
    m = torch.maximum(x, y)
    r = m + torch.log1p(torch.exp(-(x - y).abs()))
    return torch.where(m == float("-inf"), m, r)


def _linear_then(A, B, a, b):
    return A * a, a * B + b


def _linear_apply(A, B, h):
    return A * h + B


def _log_then(A, B, a, b):
    return A + a, logaddexp(a + B, b)


def _log_apply(A, B, lh):
    return logaddexp(A + lh, B)


def _log_out(A, B, lh):
    return torch.exp(B) + torch.exp(A + lh)


def _segmented(x, y, c0, ident, then, apply, out):
    """The two-level scan over dim -2 of (N, T, D) ``x``, ``y`` (the
    accumulation dtype) from ``c0`` (N, D); returns (N, T, D)."""
    n, t, d = x.shape
    tile = SEG * WARPS
    tiles = -(-t // tile)
    pad = (0, 0, 0, tiles * tile - t)
    x = F.pad(x, pad, value=ident[0]).reshape(n, tiles, WARPS, SEG, d)
    y = F.pad(y, pad, value=ident[1]).reshape(n, tiles, WARPS, SEG, d)
    carry, outs = c0, []
    for k in range(tiles):
        # phase 1: every segment's prefixes (step 0's is itself)
        A, B = x[:, k, :, 0], y[:, k, :, 0]
        pa, pb = [A], [B]
        for s in range(1, SEG):
            A, B = then(A, B, x[:, k, :, s], y[:, k, :, s])
            pa.append(A)
            pb.append(B)
        # phase 2: segment w's carry folds the aggregates before it
        carries = []
        for w in range(WARPS):
            carries.append(carry)
            carry = apply(A[:, w], B[:, w], carry)
        cw = torch.stack(carries, 1)[:, :, None]
        # phase 3: the fix-up; ``carry`` is now the tile's last state
        outs.append(out(torch.stack(pa, 2), torch.stack(pb, 2), cw)
                    .reshape(n, tile, d))
    return torch.cat(outs, 1)[:, :t]


def linear_scan_segmented(a: torch.Tensor, b: torch.Tensor,
                          h0: torch.Tensor, reverse: bool = False
                          ) -> torch.Tensor:
    """``linear_scan_ref`` in the kernel's order and rounding (a multiply
    and an add, each rounded; no FMA)."""
    acc = wide(b.dtype)
    x, y = a.to(acc), b.to(acc)
    if reverse:
        x, y = x.flip(-2), y.flip(-2)
    h = _segmented(x, y, h0.to(acc), (1.0, 0.0), _linear_then,
                   _linear_apply, _linear_apply)
    return (h.flip(-2) if reverse else h).to(b.dtype)


def log_scan_segmented(log_a: torch.Tensor, log_b: torch.Tensor,
                       log_h0: torch.Tensor) -> torch.Tensor:
    """``log_scan_ref`` in the kernel's order: log-space prefixes and
    carry, the output exp(B_t) + exp(A_t + carry)."""
    acc = wide(log_b.dtype)
    return _segmented(log_a.to(acc), log_b.to(acc), log_h0.to(acc),
                      (0.0, float("-inf")), _log_then, _log_apply, _log_out)


def inputs(gen: torch.Generator, kind: str, dtype: torch.dtype, shape,
           h0_given: bool, device) -> tuple:
    """One seeded (x, y, c0) set of (B, T, D) ``shape`` from ``gen``: the
    linear scan's a in (0.05, 0.95), b normal, h0 normal; the log scan's
    log gates of a minGRU-like layer and log_h0 = -inf (h0 = 0) or
    normal.  x, y in ``dtype``, c0 in fp32, all on ``device``."""
    bsz, _, d = shape
    if kind == "linear":
        x = 0.05 + 0.9 * torch.rand(shape, generator=gen)
        y = torch.randn(shape, generator=gen)
        c0 = torch.randn((bsz, d), generator=gen)
    else:
        k = 3 * torch.randn(shape, generator=gen)
        x = -F.softplus(k)
        y = -F.softplus(-k) + 0.3 * torch.randn(shape, generator=gen)
        c0 = (0.3 * torch.randn((bsz, d), generator=gen) if h0_given
              else torch.full((bsz, d), float("-inf")))
    return (x.to(dtype).to(device), y.to(dtype).to(device),
            c0.to(device))
