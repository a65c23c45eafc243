"""The paper's minRNN residual block (Appendix C.2).

    x = x + Down( minRNN( [Conv4]( Norm(x) ) ) )          # mixer sub-block
    x = x + MLP( Norm(x) )                                # optional

``apply`` is the parallel (training) form: under ``scan_strategy="auto"``
the cell runs in the fused CUDA layer kernel (``kernels/fused_mingru`` /
``fused_minlstm``), under ``"pallas"`` in the CUDA scans.
``step`` / ``step_chunk`` carry (conv window, h) for decode.  Under the
default ``scan_strategy="auto"`` with ``fuse_block`` "auto"/"on" the
whole block runs in ONE hand-written CUDA kernel per layer per round
(``kernels/block_step``).  The cell-fused tier (``fuse_block="off"``, or
a norm the block kernel does not pin) runs only the cell in a CUDA
kernel (``kernels/decode_step``); norm, conv window, down projection and
MLP stay PyTorch ops.  ``scan_strategy="sequential"`` is the plain
PyTorch oracle.  Under tensor-parallel serving (``distributed.context.
serving_tp``) a rank holds column blocks of the gates and ``mlp_in`` and
row blocks of ``down`` and ``mlp_out``; the row-parallel products
all-reduce their partials (:func:`_row_parallel_apply`), and such a
layer runs the cell tier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core import min_gru, min_lstm, nn
from repro_torch.core import scan as scan_lib
from repro_torch.device import resolve_device
from repro_torch.distributed import context as mesh_ctx


def fuse_block_tier(cfg: "MinRNNBlockConfig",
                    scan_strategy: Optional[str] = None, *,
                    params=None) -> str:
    """Which decode tier this block runs: ``"block-fused"`` (whole block
    in one kernel launch), ``"cell-fused"`` (cell-only kernel) or
    ``"unfused"`` (plain PyTorch).  The block tier needs ``fuse_block``
    not "off", an rmsnorm block, and -- given ``params`` under
    ``serving_tp`` -- unsplit row-parallel kernels: a TP-split layer's
    ``down`` / ``mlp_out`` products all-reduce over the model group,
    which stays outside the kernel, so split layers take the cell
    tier."""
    strategy = scan_strategy if scan_strategy is not None \
        else cfg.scan_strategy
    if scan_lib.resolve_strategy(strategy) != "fused":
        return "unfused"
    if cfg.fuse_block == "off" or cfg.norm != "rmsnorm":
        return "cell-fused"
    if params is not None and mesh_ctx.serving_tp_group() is not None:
        if params["down"]["kernel"].shape[0] != cfg.d_hidden:
            return "cell-fused"
        if cfg.use_mlp and \
                params["mlp_out"]["kernel"].shape[0] != cfg.d_mlp:
            return "cell-fused"
    return "block-fused"


def _row_parallel_apply(p, x, compute_dtype, full_in_dim: int):
    """``dense_apply`` that understands tensor-parallel serving.

    Under ``serving_tp`` the column-parallel projections (gates,
    ``mlp_in``) hand each model rank a ``d_hidden/model`` (``d_ff/model``)
    column block, so the row-parallel projections that contract over it
    (``down``, ``mlp_out``) hold a row block: ``kernel.shape[0] <
    full_in_dim``.  Their product is then a partial sum, all-reduced over
    the model group in the compute dtype BEFORE the bias (whole on every
    rank) is added.  Without the context, or with a whole kernel (pure
    DP; a draft model's whole weights under a TP mesh), this is exactly
    ``dense_apply``.

    ``x`` may also be a list of tensors (a chunk's positions, each at the
    step's shape): each gets its own product, and one all-reduce carries
    all their partials (a sum of the same elements in any layout)."""
    group = mesh_ctx.serving_tp_group()
    k = p["kernel"]
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    if group is None or k.shape[0] == full_in_dim:
        ys = [nn.dense_apply(p, t, compute_dtype) for t in xs]
    else:
        import torch.distributed as dist
        if compute_dtype is not None:
            k = k.to(compute_dtype)
        ys = [(t if compute_dtype is None else t.to(compute_dtype)) @ k
              for t in xs]
        flat = torch.cat([y.reshape(-1) for y in ys])
        dist.all_reduce(flat, group=group)
        ys = [part.view(y.shape) for part, y in
              zip(flat.split([y.numel() for y in ys]), ys)]
        if "bias" in p:
            b = p["bias"]
            if compute_dtype is not None:
                b = b.to(compute_dtype)
            ys = [y + b for y in ys]
    return ys if isinstance(x, (list, tuple)) else ys[0]


@dataclass(frozen=True)
class MinRNNBlockConfig:
    d_model: int
    cell: str = "mingru"            # mingru | minlstm
    expansion: float = 1.0          # alpha
    use_conv: bool = False
    conv_kernel: int = 4
    use_mlp: bool = False
    mlp_factor: float = 4.0
    mode: str = "log"               # log | linear
    norm: str = "rmsnorm"
    scan_strategy: str = "auto"
    fuse_block: str = "auto"        # auto | on | off

    @property
    def d_hidden(self) -> int:
        return int(self.d_model * self.expansion)

    @property
    def d_mlp(self) -> int:
        return int(self.d_model * self.mlp_factor)


_CELLS = {"mingru": min_gru, "minlstm": min_lstm}


def init(gen: torch.Generator, cfg: MinRNNBlockConfig, *,
         dtype=torch.float32):
    cell = _CELLS[cfg.cell]
    p = {
        "norm_rnn": nn.norm_init(cfg.norm, cfg.d_model, dtype),
        "rnn": cell.init(gen, cfg.d_model, cfg.d_hidden, dtype=dtype),
        "down": nn.dense_init(gen, cfg.d_hidden, cfg.d_model,
                              use_bias=False, dtype=dtype),
    }
    if cfg.use_conv:
        p["conv"] = nn.causal_conv_init(gen, cfg.d_model, cfg.conv_kernel,
                                        dtype)
    if cfg.use_mlp:
        p["norm_mlp"] = nn.norm_init(cfg.norm, cfg.d_model, dtype)
        p["mlp_in"] = nn.dense_init(gen, cfg.d_model, cfg.d_mlp,
                                    dtype=dtype)
        p["mlp_out"] = nn.dense_init(gen, cfg.d_mlp, cfg.d_model,
                                     dtype=dtype)
    return p


def apply(params, cfg: MinRNNBlockConfig, x: torch.Tensor, *,
          h0: Optional[torch.Tensor] = None, state0=None, lengths=None,
          compute_dtype=None, scan_strategy: Optional[str] = None,
          return_state: bool = False):
    """x: (..., T, d_model) parallel (training / prefill) form, from
    ``h0`` (or the zero state).  ``scan_strategy`` overrides
    ``cfg.scan_strategy``.

    ``return_state`` also returns the decode-ready state {"h"[, "conv"]}
    (the final h and conv window), so a prefill hands off to ``step``.
    ``lengths`` (B,) takes that state at each row's last real position of
    a right-padded batch (every mixer is causal, so the pad never reaches
    it).  ``state0`` (an earlier ``return_state`` dict) resumes from a
    carried (h, conv window): the chunked-prefill path.  Block dropout is
    not ported (the LM configs never set it)."""
    if scan_strategy is None:
        scan_strategy = cfg.scan_strategy
    cell = _CELLS[cfg.cell]
    y = nn.norm_apply(cfg.norm, params["norm_rnn"], x)
    state = {}
    if state0 is not None:
        h0 = state0["h"]
    conv0 = state0.get("conv") if (state0 is not None and cfg.use_conv) \
        else None
    if cfg.use_conv:
        if return_state:
            width = cfg.conv_kernel - 1
            if lengths is not None or conv0 is not None:
                lens = lengths if lengths is not None else torch.full(
                    y.shape[:1], y.shape[-2], dtype=torch.int32,
                    device=y.device)
                state["conv"] = nn.gather_conv_window(y, lens, width,
                                                      prefix=conv0)
            else:
                pad = max(width - y.shape[-2], 0)
                win = y[..., -width:, :]
                if pad:
                    win = torch.cat([y.new_zeros(
                        y.shape[:-2] + (pad, y.shape[-1])), win], dim=-2)
                state["conv"] = win
        y = nn.causal_conv_apply(params["conv"], y, prefix=conv0)
    h = cell.parallel(params["rnn"], y, h0, mode=cfg.mode,
                      scan_strategy=scan_strategy,
                      compute_dtype=compute_dtype)
    if return_state:
        state["h"] = nn.gather_last(h, lengths) if lengths is not None \
            else h[..., -1, :]
    x = _tail(params, cfg, [x], [h], compute_dtype)[0]
    if return_state:
        return x, state
    return x


def init_state(cfg: MinRNNBlockConfig, batch_shape: Tuple[int, ...],
               dtype=torch.float32, device="cuda"):
    """Decode-time carried state for one block, on ``device`` (the card
    unless the caller asks for the CPU, as every entry point)."""
    device = resolve_device(device)
    state = {"h": torch.zeros(batch_shape + (cfg.d_hidden,), dtype=dtype,
                              device=device)}
    if cfg.use_conv:
        state["conv"] = torch.zeros(
            batch_shape + (cfg.conv_kernel - 1, cfg.d_model), dtype=dtype,
            device=device)
    return state


def bind(params, cfg: MinRNNBlockConfig, *, compute_dtype=None,
         scan_strategy: Optional[str] = None):
    """The block's weights bound once for its kernel, for ``step`` /
    ``step_chunk``'s ``operands``: a ``BlockOperands`` (whole block) on
    the block-fused tier, a ``CellOperands`` (the cell's gates, in the
    compute dtype, zero biases made once) on the cell-fused tier, None on
    the CPU or the unfused tier (nothing to bind)."""
    tier = fuse_block_tier(cfg, scan_strategy, params=params)
    if tier == "unfused" or params["down"]["kernel"].device.type != "cuda":
        return None
    if tier == "cell-fused":
        from repro_torch.kernels.decode_step import ops as step_ops
        return step_ops.CellOperands.from_params(params["rnn"], cfg.cell,
                                                 compute_dtype)
    from repro_torch.kernels.block_step import ops as block_ops
    return block_ops.BlockOperands(params, cell=cfg.cell,
                                   compute_dtype=compute_dtype,
                                   use_conv=cfg.use_conv, use_mlp=cfg.use_mlp)


def step(params, cfg: MinRNNBlockConfig, x_t: torch.Tensor, state, *,
         compute_dtype=None, scan_strategy: Optional[str] = None,
         operands=None):
    """Single-token decode. x_t: (B, d_model) -> (y, new state).
    ``operands``: this block's :func:`bind`, if the caller holds one."""
    if scan_strategy is None:
        scan_strategy = cfg.scan_strategy
    tier = fuse_block_tier(cfg, scan_strategy, params=params)
    if tier == "block-fused":
        from repro_torch.kernels.block_step import ops as block_ops
        return block_ops.fused_block_step(
            params, x_t, state, cell=cfg.cell, mode=cfg.mode,
            use_conv=cfg.use_conv, use_mlp=cfg.use_mlp,
            compute_dtype=compute_dtype, operands=operands)
    # cell-fused (the cell in its kernel, ``operands`` its binding) or
    # unfused: the norm, conv, down projection and MLP are PyTorch ops
    cell = _CELLS[cfg.cell]
    y = nn.norm_apply(cfg.norm, params["norm_rnn"], x_t)
    new_state = dict(state)
    if cfg.use_conv:
        y, new_state["conv"] = nn.causal_conv_step(params["conv"], y,
                                                   state["conv"])
    h = cell.step(params["rnn"], y, state["h"], mode=cfg.mode,
                  compute_dtype=compute_dtype, scan_strategy=scan_strategy,
                  operands=operands)
    new_state["h"] = h
    return _tail(params, cfg, [x_t], [h], compute_dtype)[0], new_state


def _tail(params, cfg: MinRNNBlockConfig, xs, hs, compute_dtype):
    """The block after its cell, for positions ``xs[t]``, ``hs[t]``: x +
    Down(h), then the MLP sub-block.  Under serving TP each sub-block
    all-reduces the partials of every position at once."""
    ys = _row_parallel_apply(params["down"], hs, compute_dtype, cfg.d_hidden)
    xs = [x + y for x, y in zip(xs, ys)]
    if cfg.use_mlp:
        zs = [nn.gelu(nn.dense_apply(
            params["mlp_in"], nn.norm_apply(cfg.norm, params["norm_mlp"], x),
            compute_dtype)) for x in xs]
        ys = _row_parallel_apply(params["mlp_out"], zs, compute_dtype,
                                 cfg.d_mlp)
        xs = [x + y for x, y in zip(xs, ys)]
    return xs


def step_chunk(params, cfg: MinRNNBlockConfig, x: torch.Tensor, state,
               valid: torch.Tensor, *, compute_dtype=None,
               scan_strategy: Optional[str] = None,
               return_positions: bool = False, operands=None):
    """Packed varlen decode chunk: x (B, C, d_model), valid (B,) int32 in
    [1, C].  Row b consumes its first ``valid[b]`` positions with the
    per-token arithmetic of ``valid[b]`` sequential :func:`step` calls;
    its carried state freezes after.  ``return_positions`` also returns
    the state after every position."""
    if scan_strategy is None:
        scan_strategy = cfg.scan_strategy
    tier = fuse_block_tier(cfg, scan_strategy, params=params)
    if tier == "block-fused":
        from repro_torch.kernels.block_step import ops as block_ops
        return block_ops.fused_block_chunk(
            params, x, state, valid, cell=cfg.cell, mode=cfg.mode,
            use_conv=cfg.use_conv, use_mlp=cfg.use_mlp,
            compute_dtype=compute_dtype, return_positions=return_positions,
            operands=operands)
    # cell-fused or unfused: the cell over the chunk in one call (one
    # kernel launch on the cell tier); every other op one position at a
    # time, with the shapes ``step`` gives it -- a reduction's or a matrix
    # product's summation order may depend on its row count (cuBLAS picks
    # a kernel by shape), and a chunk must equal C steps bit for bit
    cell = _CELLS[cfg.cell]
    chunk = x.shape[1]
    xs = [x[:, t].contiguous() for t in range(chunk)]
    ys, wins = [], []
    win = state.get("conv")
    for t in range(chunk):
        y = nn.norm_apply(cfg.norm, params["norm_rnn"], xs[t])
        if cfg.use_conv:
            y, win_new = nn.causal_conv_step(params["conv"], y, win)
            win = torch.where((t < valid)[:, None, None], win_new, win)
            wins.append(win)
        ys.append(y)
    hs = cell.step_chunk(params["rnn"], torch.stack(ys, dim=1), state["h"],
                         valid, mode=cfg.mode, compute_dtype=compute_dtype,
                         scan_strategy=scan_strategy, operands=operands)
    new_state = dict(state)
    new_state["h"] = hs[:, -1]          # frozen rows: == hs[:, valid-1]
    pos_states = {"h": hs}
    if cfg.use_conv:
        new_state["conv"] = win
        pos_states["conv"] = torch.stack(wins, dim=1)
    x = torch.stack(_tail(params, cfg, xs, [hs[:, t].contiguous()
                                            for t in range(chunk)],
                          compute_dtype), dim=1)
    if return_positions:
        return x, new_state, pos_states
    return x, new_state
