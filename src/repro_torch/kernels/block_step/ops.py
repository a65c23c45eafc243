"""Wrappers for the whole-block decode kernel (``csrc/block_step.cu``).

``fused_block_step`` / ``fused_block_chunk`` take one minRNN block's
param dict (``blocks.init`` layout) and its carried decode state and run
the ENTIRE block -- norm, conv step, cell, down-projection, MLP -- in one
kernel launch.  A CPU tensor goes to the plain version in ``ref.py``; a
CUDA tensor launches the kernel or raises; a fake CUDA tensor takes the
shape-only route (``kernels/launch.py``).  Nothing falls back.

Dtype contract (as ``repro.kernels.block_step.ops``): gate / down / MLP
weights and biases are cast to the compute dtype here, exactly where the
reference casts them; norm scales and conv params are passed uncast.
The kernel has one element type, so on CUDA every operand must then be
in the activation dtype (fp32 or bf16) -- true for the LM, whose params,
activations and cache share the compute dtype.  Any feature dims run,
with no padding: dims that 16 (the kernel's column tile) does not
divide take the streamed body with a ragged last tile, loading element by
element.  Other dims load 16-byte vectors, so an operand off a 16-byte
boundary is copied (weights once, when bound; activations at the
launch) -- never the case for the engine's own tensors.

The step form is the chunk form at C = 1 with every position valid: one
kernel, so "a C-token chunk equals C steps" holds by construction.

The C launcher picks one of two bodies from the dims, the element type
and the card (never from B, C or the data), so a row's bits depend on
neither B nor C.  "split", where one block's weight slices for a position
fit in its shared memory (bf16 at mingru-lm / minlstm-lm width), splits
each phase's contraction into K slices chosen from the dims alone, keeps
the slices resident for the launch, and reduces them through fp32
partials and per-column-tile arrival counters in device memory.  Both
are bound with the weights (:class:`BlockOperands`): the counters are
zeroed once there and every launch leaves them zero again, so one
binding runs on one stream at a time (the engine's layers do).
"streamed" (every other shape, e.g. fp32 at those widths, and every
ragged one) streams each 16-column unit's weights over the whole
contraction from global memory and stages 8 input rows in fp32 in shared
memory: whole rows where they fit (K up to 7134), else K slices of at
most 7104 rows chosen from K alone, each thread's sums carried across
them in the order of whole rows.  So every shape binds and runs.
:func:`plan` reports what a launch runs: the body, each phase's split,
units and the most weight bytes one block streams, the grid, blocks per
SM and shared memory.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import launch as kl
from repro_torch.kernels.block_step import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "block_step.cu"

# launches per wrapper: a plain count, reset by whoever reads it
LAUNCHES = {"block_step_kernel": 0, "block_chunk_kernel": 0}

_GATES = {"mingru": ("wz", "wh"), "minlstm": ("wf", "wi", "wh")}
_DTYPES = kl.DTYPES
_N_PTRS = 27
_PHASES = ("A", "B", "C", "D")
_PLAN_HEAD = ("n_phases", "body", "grid", "blocks_per_sm", "sms", "smem",
              "ring_bytes", "partials_per_tile", "counters")
_BODIES = ("streamed", "split")
_PLAN_PHASE = ("K", "N", "gates", "S", "slice_rows", "units",
               "max_block_jobs", "job_bytes")
_LIB = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE)
        lib.repro_block_launch.argtypes = (
            [ctypes.c_int] * 11
            + [ctypes.c_void_p, ctypes.c_void_p,
               ctypes.POINTER(ctypes.c_int)])
        lib.repro_block_launch.restype = ctypes.c_int
        lib.repro_block_plan.argtypes = [ctypes.c_int] * 8 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.repro_block_plan.restype = ctypes.c_int
        kl.declare_error_string(lib)
        _LIB = lib
    return _LIB


def _cast(a, cd):
    return a if cd is None else a.to(cd)


def kernel_params(params, cell: str, compute_dtype, use_conv: bool,
                  use_mlp: bool):
    """The block params with the compute-dtype casts of the reference
    wrapper applied (gate / down / MLP weights and biases)."""
    rnn = {}
    for name in _GATES[cell]:
        p = params["rnn"][name]
        rnn[name] = {"kernel": _cast(p["kernel"], compute_dtype)}
        if "bias" in p:
            rnn[name]["bias"] = _cast(p["bias"], compute_dtype)
    out = {"norm_rnn": params["norm_rnn"], "rnn": rnn,
           "down": {"kernel": _cast(params["down"]["kernel"],
                                    compute_dtype)}}
    if use_conv:
        out["conv"] = params["conv"]
    if use_mlp:
        out["norm_mlp"] = params["norm_mlp"]
        for name in ("mlp_in", "mlp_out"):
            out[name] = {k: _cast(v, compute_dtype)
                         for k, v in params[name].items()}
    return out


def _check(t: torch.Tensor, name: str, shape, dtype,
           device) -> torch.Tensor:
    """``t`` checked (the kernel runs one element type for activations,
    state and params) and on a 16-byte boundary, for the kernel's vector
    loads: a copy of it where it is not."""
    kl.check(t, name, shape, dtype, device)
    if kl.shape_only(t):            # a dry run's operand has no address
        return t
    return t.clone() if t.data_ptr() % 16 else t


class BlockOperands:
    """One block's weight operands, bound for the kernel once: the
    compute-dtype casts of the reference wrapper applied, every leaf
    checked (device, dtype, shape, contiguity, alignment) and its pointer
    taken.  It holds the tensors it points at, so they live as long as it
    does, and it reads the params as they were when bound: whoever owns
    the params binds them (``blocks.bind``, ``lm.bind_layers``) and binds
    again after replacing a leaf.  A decode round then checks and binds
    only its activations.

    It also holds the split body's scratch: the arrival counters (zeroed
    here; every launch leaves them zero) and the fp32 partials (grown to
    the largest batch seen).  So a binding serves one stream at a time.
    ``body`` is the body the launches run (:func:`plan`): every shape has
    one.  A leaf off a 16-byte boundary is bound as an aligned copy."""

    def __init__(self, params, *, cell, compute_dtype, use_conv, use_mlp):
        if cell not in _GATES:
            raise ValueError(f"unknown cell {cell!r}")
        self.key = (cell, compute_dtype, use_conv, use_mlp)
        kp = kernel_params(params, cell, compute_dtype, use_conv, use_mlp)
        down = kp["down"]["kernel"]
        dev, dt = down.device, down.dtype
        if dev.type != "cuda":
            raise ValueError(f"block kernel needs CUDA tensors, got {dev}")
        if dt not in _DTYPES:
            raise ValueError(f"block kernel runs fp32 or bf16, got {dt}")
        dh, dx = down.shape
        dm = kp["mlp_in"]["kernel"].shape[1] if use_mlp else 0
        ptrs = [0] * _N_PTRS
        keep = []
        fake = kl.shape_only(down)

        def bind(i, t, name, shape):
            t = _check(t, name, shape, dt, dev)
            ptrs[i] = 0 if fake else t.data_ptr()
            keep.append(t)

        bind(1, kp["norm_rnn"]["scale"], "norm_rnn.scale", (dx,))
        ksize = 0
        if use_conv:
            ck, cb = kp["conv"]["kernel"], kp["conv"]["bias"]
            ksize = ck.shape[0]
            bind(2, ck, "conv.kernel", (ksize, dx))
            bind(3, cb, "conv.bias", (dx,))
        for g, gname in enumerate(_GATES[cell]):
            b = kp["rnn"][gname].get("bias")
            if b is None:
                b = torch.zeros((dh,), dtype=dt, device=dev)
            bind(5 + g, kp["rnn"][gname]["kernel"], f"rnn.{gname}.kernel",
                 (dx, dh))
            bind(8 + g, b, f"rnn.{gname}.bias", (dh,))
        bind(12, down, "down.kernel", (dh, dx))
        if use_mlp:
            named = (("norm_mlp", "scale", (dx,)),
                     ("mlp_in", "kernel", (dx, dm)), ("mlp_in", "bias", (dm,)),
                     ("mlp_out", "kernel", (dm, dx)),
                     ("mlp_out", "bias", (dx,)))
            for i, (mod, leaf, shape) in enumerate(named):
                bind(13 + i, kp[mod][leaf], f"{mod}.{leaf}", shape)
        self.cell, self.use_conv, self.use_mlp = cell, use_conv, use_mlp
        self.device, self.dtype = dev, dt
        self.dims = (dx, dh, dm, ksize)
        self.ptrs = ptrs
        self._keep = keep
        if fake:            # a dry run's binding: checked, no plan, no scratch
            self.body = None
            return
        layout = plan(self)
        self.body = layout["body"]
        self._part_per_tile = layout["partials_per_tile"]
        self._cnt = torch.zeros((layout["counters"],), dtype=torch.int32,
                                device=dev)
        self._part = torch.empty((0,), dtype=torch.float32, device=dev)
        ptrs[26] = self._cnt.data_ptr()

    def partials(self, bsz: int) -> torch.Tensor:
        """The fp32 partial-sum scratch for a launch on ``bsz`` rows."""
        need = -(-bsz // 8) * self._part_per_tile
        if self._part.numel() < need:
            self._part = torch.empty((need,), dtype=torch.float32,
                                     device=self.device)
        return self._part


def _operands(params, operands, cell, compute_dtype, use_conv, use_mlp):
    """``operands`` when the caller bound them (checked against the
    call's options), else a binding made for this one call."""
    if operands is None:
        return BlockOperands(params, cell=cell, compute_dtype=compute_dtype,
                             use_conv=use_conv, use_mlp=use_mlp)
    if operands.key != (cell, compute_dtype, use_conv, use_mlp):
        raise ValueError(f"operands were bound for {operands.key}, the call "
                         f"asks for {(cell, compute_dtype, use_conv, use_mlp)}")
    return operands


def plan(operands: BlockOperands) -> dict:
    """What every launch of ``operands`` runs (any B, any C), from the C
    launcher's own plan (``repro_block_plan``, the same code and cache the
    launch uses) and the occupancy query; launches nothing.  {"body"
    ("split": K-split phases, each block's weight slices resident in
    shared memory, ``ring_bytes`` of them; "streamed": a unit per 16
    columns over all of K), "grid", "blocks_per_sm", "sms", "smem",
    "ring_bytes", "partials_per_tile", "counters", "phases": [{"name",
    "K", "N", "gates", "S", "slice_rows", "units", "max_block_jobs",
    "job_bytes", "max_block_bytes"}, ...]}; on the streamed body S > 1
    where a phase's K is staged in slices of ``slice_rows``."""
    lib = _lib()
    dx, dh, dm, ksize = operands.dims
    out = (ctypes.c_int * (len(_PLAN_HEAD) + 4 * len(_PLAN_PHASE)))()
    with torch.cuda.device(operands.device):
        rc = lib.repro_block_plan(
            int(operands.cell == "minlstm"), _DTYPES[operands.dtype],
            int(operands.use_conv), int(operands.use_mlp), dx, dh, dm, ksize,
            out)
    kl.raise_on_error(lib, "block plan", rc)
    vals = list(out)
    res = dict(zip(_PLAN_HEAD, vals))
    res["body"] = _BODIES[res["body"]]
    phases = []
    for x in range(res.pop("n_phases")):
        o = len(_PLAN_HEAD) + x * len(_PLAN_PHASE)
        ph = dict(zip(_PLAN_PHASE, vals[o:o + len(_PLAN_PHASE)]))
        ph["max_block_bytes"] = ph["max_block_jobs"] * ph["job_bytes"]
        phases.append({"name": _PHASES[x], **ph})
    res["phases"] = phases
    return res


def prepare_launch(operands: BlockOperands, x, state, valid, *, mode,
                   trace=None):
    """Check the activations, allocate the outputs and bind the C call.
    Returns ``(launch, (ys, hs, wins))``: ``launch()`` issues the kernel on
    the current stream and returns its CUDA status; it does not count.
    ``launch.args`` are its ``repro_block_launch`` arguments.
    x: (B, C, Dx) on CUDA -> ys (B, C, Dx), hs (B, C, Dh), wins
    (B, C, K-1, Dx) or None.  ``trace``, an int64 (1 + 7 C,) CUDA tensor,
    receives block 0's ``%globaltimer`` (ns) at launch and, per position,
    after phase A, barrier, B, barrier, C, barrier, D (``phase_times``)."""
    dev, dt = operands.device, operands.dtype
    if mode not in ("log", "linear"):
        raise ValueError(f"unknown mode {mode!r}")
    dx, dh, dm, ksize = operands.dims
    use_conv, use_mlp = operands.use_conv, operands.use_mlp
    bsz, chunk = x.shape[0], x.shape[1]
    x = _check(x, "x", (bsz, chunk, dx), dt, dev)
    h0 = _check(state["h"], "state['h']", (bsz, dh), dt, dev)
    ptrs = list(operands.ptrs)
    ptrs[0], ptrs[11] = x.data_ptr(), h0.data_ptr()
    keep = [operands, x, h0]
    if use_conv:
        win = _check(state["conv"], "state['conv']", (bsz, ksize - 1, dx),
                     dt, dev)
        ptrs[4] = win.data_ptr()
        keep.append(win)
    if valid is not None:
        kl.check(valid, "valid", (bsz,), torch.int32, dev)
        ptrs[18] = valid.data_ptr()
        keep.append(valid)
    if trace is not None:
        kl.check(trace, "trace", (1 + 7 * chunk,), torch.int64, dev)
        ptrs[24] = trace.data_ptr()
        keep.append(trace)

    ys = torch.empty((bsz, chunk, dx), dtype=dt, device=dev)
    hs = torch.empty((bsz, chunk, dh), dtype=dt, device=dev)
    wins = torch.empty((bsz, chunk, ksize - 1, dx), dtype=dt, device=dev) \
        if use_conv else None
    ptrs[19], ptrs[20] = ys.data_ptr(), hs.data_ptr()
    if use_conv:
        ptrs[21] = wins.data_ptr()
    if use_mlp:
        xr = torch.empty((bsz, dx), dtype=dt, device=dev)
        m = torch.empty((bsz, dm), dtype=dt, device=dev)
        ptrs[22], ptrs[23] = xr.data_ptr(), m.data_ptr()
        keep += [xr, m]
    part = operands.partials(bsz)
    ptrs[25] = part.data_ptr()
    keep += [ys, hs, wins, part]

    lib = _lib()
    grid = ctypes.c_int(0)
    args = (int(operands.cell == "minlstm"), int(mode == "log"), _DTYPES[dt],
            int(use_conv), int(use_mlp), bsz, chunk, dx, dh, dm, ksize,
            (ctypes.c_void_p * _N_PTRS)(*ptrs),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
            ctypes.byref(grid))

    def launch(_keep=keep):        # _keep: operands alive while bound
        return lib.repro_block_launch(*args)

    launch.grid = grid
    launch.args = args      # the C call's arguments (``ab.py`` times them)
    return launch, (ys, hs, wins)


def phase_times(trace: torch.Tensor, use_mlp: bool = True) -> dict:
    """Microseconds per phase and per barrier wait, summed over the
    positions of one traced launch, from block 0's clock: "A" is block
    0's own units of phase A (on the split body also its arrivals and the
    epilogues it completes), "sync_A" its wait for the slowest block at
    the barrier after it."""
    ticks = trace.cpu().tolist()
    names = ("A", "sync_A", "B", "sync_B", "C", "sync_C", "D")
    out = {n: 0.0 for n in (names if use_mlp else names[:3])}
    prev = ticks[0]
    for t in range((len(ticks) - 1) // 7):
        for i, n in enumerate(out):
            cur = ticks[1 + 7 * t + i]
            out[n] += (cur - prev) * 1e-3
            prev = cur
    return out


def work(kernel: str, cell: str, dtype: torch.dtype, bsz: int, chunk: int,
         dims, *, use_conv: bool = True, use_mlp: bool = True):
    """(flops, bytes) of one launch of ``kernel`` ("block_step_kernel" or
    "block_chunk_kernel") on (B, C, Dx) x of ``dtype``, ``dims`` = (Dx,
    Dh, Dm, conv K) as ``BlockOperands.dims``: the gate, down and MLP
    products' and the conv taps' multiply-adds (the plain version's conv
    step is a product); every weight, x, h and the conv window read
    once (and a chunk's int32 valid lengths), ys, hs and the windows
    written once."""
    dx, dh, dm, ksize = dims
    n_g = len(_GATES[cell])
    e = torch.tensor([], dtype=dtype).element_size()
    weights = n_g * (dx * dh + dh) + dh * dx + dx
    elems_in = bsz * chunk * dx + bsz * dh
    elems_out = bsz * chunk * (dx + dh)
    products = n_g * dx * dh + dh * dx
    if use_conv:
        products += ksize * dx
        weights += ksize * dx + dx
        elems_in += bsz * (ksize - 1) * dx
        elems_out += bsz * chunk * (ksize - 1) * dx
    if use_mlp:
        weights += dx + dx * dm + dm + dm * dx + dx
        products += 2 * dx * dm
    nbytes = (weights + elems_in + elems_out) * e
    if "chunk" in kernel:
        nbytes += 4 * bsz
    return 2 * bsz * chunk * products, nbytes


def _shape_only(name, operands, x, state, valid):
    """A dry run's launch on fake operands: the launch's checks and
    outputs, its work recorded (``kernels/launch.py``)."""
    dev, dt = operands.device, operands.dtype
    dx, dh, dm, ksize = operands.dims
    bsz, chunk = x.shape[0], x.shape[1]
    kl.check(x, "x", (bsz, chunk, dx), dt, dev)
    kl.check(state["h"], "state['h']", (bsz, dh), dt, dev)
    if operands.use_conv:
        kl.check(state["conv"], "state['conv']", (bsz, ksize - 1, dx), dt,
                 dev)
    if valid is not None:
        kl.check(valid, "valid", (bsz,), torch.int32, dev)
    kl.record(name, 1, work(name, operands.cell, dt, bsz, chunk,
                            operands.dims, use_conv=operands.use_conv,
                            use_mlp=operands.use_mlp))
    wins = torch.empty((bsz, chunk, ksize - 1, dx), dtype=dt, device=dev) \
        if operands.use_conv else None
    return (torch.empty((bsz, chunk, dx), dtype=dt, device=dev),
            torch.empty((bsz, chunk, dh), dtype=dt, device=dev), wins)


def _launch(name, operands, x, state, valid, *, mode):
    if kl.shape_only(x):
        return _shape_only(name, operands, x, state, valid)
    launch, outs = prepare_launch(operands, x, state, valid, mode=mode)
    rc = launch()
    kl.raise_on_error(_lib(), name, rc)
    LAUNCHES[name] += 1
    return outs


def fused_block_step(params, x_t: torch.Tensor, state: dict, *,
                     cell: str = "mingru", mode: str = "log",
                     use_conv: bool = False, use_mlp: bool = False,
                     compute_dtype=None, operands=None):
    """One whole-block decode step in one launch.  x_t: (B, D), state:
    {"h": (B, Dh)[, "conv": (B, K-1, D)]} -> (y, new_state).  On CUDA,
    ``operands`` (a :class:`BlockOperands` of ``params``) skips binding
    the weights again."""
    if x_t.device.type == "cpu":
        kp = kernel_params(params, cell, compute_dtype, use_conv, use_mlp)
        return ref.block_step_ref(kp, x_t, state, cell=cell, mode=mode,
                                  use_conv=use_conv, use_mlp=use_mlp,
                                  compute_dtype=compute_dtype)
    operands = _operands(params, operands, cell, compute_dtype, use_conv,
                         use_mlp)
    ys, hs, wins = _launch("block_step_kernel", operands, x_t.unsqueeze(1),
                           state, None, mode=mode)
    new_state = dict(state)
    new_state["h"] = hs.select(1, 0)
    if use_conv:
        new_state["conv"] = wins.select(1, 0)
    return ys.select(1, 0), new_state


def fused_block_chunk(params, x: torch.Tensor, state: dict,
                      valid: torch.Tensor, *, cell: str = "mingru",
                      mode: str = "log", use_conv: bool = False,
                      use_mlp: bool = False, compute_dtype=None,
                      return_positions: bool = False, operands=None):
    """Varlen C-token whole-block chunk in one launch (packed prefill).
    x: (B, C, D), valid: (B,) int32 in [1, C] -> (ys, new_state[,
    per-position states]); frozen rows re-emit their final state."""
    if x.device.type == "cpu":
        kp = kernel_params(params, cell, compute_dtype, use_conv, use_mlp)
        ys, new_state, pos = ref.block_chunk_ref(
            kp, x, state, valid, cell=cell, mode=mode, use_conv=use_conv,
            use_mlp=use_mlp, compute_dtype=compute_dtype)
    else:
        operands = _operands(params, operands, cell, compute_dtype, use_conv,
                             use_mlp)
        ys, hs, wins = _launch("block_chunk_kernel", operands, x, state,
                               valid.to(torch.int32), mode=mode)
        new_state = dict(state)
        new_state["h"] = hs.select(1, -1)
        pos = {"h": hs}
        if use_conv:
            new_state["conv"] = wins.select(1, -1)
            pos["conv"] = wins
    if return_positions:
        return ys, new_state, pos
    return ys, new_state
