"""Wrappers for the cell-only decode kernels (``csrc/decode_step.cu``).

``fused_mingru_step`` / ``fused_minlstm_step`` run one cell step
(projections + gates + state update) for any leading batch dims, x
(..., Dx) and h_prev (..., Dh) -> h (..., Dh); ``fused_mingru_chunk`` /
``fused_minlstm_chunk`` a varlen C-token chunk, x (..., C, Dx) and valid
(...,) -> hs (..., C, Dh), row b frozen once ``t >= valid[b]``, each
position bit-identical to the step.  A missing bias means zeros.  The
output is in x's dtype; h_prev may be x's dtype or float32.

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor
launches the kernel or raises; a fake CUDA tensor takes the shape-only
route (``kernels/launch.py``).  Nothing falls back.  The norm, conv,
down projection and MLP around the cell stay PyTorch ops
(``blocks.step``).

Weights are bound once by whoever owns them (:class:`CellOperands`, made
by ``blocks.bind`` / ``lm.bind_layers``): cast to the compute dtype, made
contiguous, missing biases made as zeros, checked, pointers taken.  A
call given ``operands=`` then checks and binds only its activations; a
call without binds its weights for itself.

Binding also picks the kernel body (:func:`cell_body`): the tensor-core
body for minGRU and minLSTM in bf16 at widths and addresses it takes, the
CUDA-core body for fp32 and any other bf16.  The choice rests on the bound weights alone,
never on x or C, so a layer's steps and chunks run one body; the C
launcher runs the body it is given or refuses the launch.  Each body's
launches are counted beside the kernel's total
(``LAUNCHES["mingru_step_kernel/tc"]``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import launch as kl
from repro_torch.kernels.decode_step import ref
from repro_torch.kernels.launch import waves
from repro_torch.kernels.scan.ops import call_with_flat_lead

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_step.cu"

KERNELS = ("mingru_step_kernel", "mingru_chunk_kernel",
           "minlstm_step_kernel", "minlstm_chunk_kernel")
# the kernel's bodies, by the C launcher's number (1: tensor cores)
BODIES = ("cuda_core", "tc")
# launches per kernel and per kernel and body ("mingru_step_kernel/tc"):
# plain counts, reset by whoever reads them
LAUNCHES = {**{k: 0 for k in KERNELS},
            **{f"{k}/{b}": 0 for k in KERNELS for b in BODIES}}

GATES = {"mingru": ("wz", "wh"), "minlstm": ("wf", "wi", "wh")}
# the widest Dx whose whole weight tile the tensor-core body keeps in
# shared memory (csrc/decode_step.cu, tc::kMaxDx)
TC_MAX_DX = 4096
# csrc/decode_step.cu's kBT and kMaxTiles: batch rows a tile, batch tiles
# a launch (the launcher splits a larger batch over launches)
ROWS_PER_TILE, MAX_TILES = 8, 65535
_N_PTRS = 10
_LIB = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE)
        for fn in (lib.repro_cell_step_launch, lib.repro_cell_chunk_launch):
            fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p,
                                                ctypes.c_void_p,
                                                ctypes.c_int]
            fn.restype = ctypes.c_int
        lib.repro_cell_occupancy.argtypes = [ctypes.c_int] * 7 + [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        lib.repro_cell_occupancy.restype = ctypes.c_int
        lib.repro_cell_launches.argtypes = [ctypes.c_int]
        lib.repro_cell_launches.restype = ctypes.c_int
        kl.declare_error_string(lib)
        _LIB = lib
    return _LIB


def cell_body(cell: str, dtype: torch.dtype, dx: int, dh: int,
              aligned: bool) -> str:
    """The kernel body a cell bound with these weights runs: "tc" (tensor
    cores) for minGRU or minLSTM in bf16 whose Dx and Dh are multiples of
    8, Dx at most ``TC_MAX_DX``, and whose weights (every gate's) start on
    16-byte boundaries (``aligned``); "cuda_core" for fp32 (the exact
    path) and any other bf16, at any width: past the widest 8 rows of x
    its shared memory holds (Dx 7136 in fp32, 14272 in bf16) it stages x
    in K slices, summing in the same order."""
    if cell not in GATES:
        raise ValueError(f"unknown cell {cell!r}")
    tc = (dtype == torch.bfloat16 and dx % 8 == 0 and dh % 8 == 0
          and dx <= TC_MAX_DX and aligned)
    return "tc" if tc else "cuda_core"


class CellOperands:
    """One cell's gate weights bound for the kernel: every weight and bias
    in one dtype (fp32 or bf16), contiguous, on one CUDA device, missing
    biases made as zeros once, and the body the kernel runs on them
    (``body``, :func:`cell_body`).  It holds the tensors it points at and
    reads them as they were when bound: bind again after replacing a
    leaf."""

    def __init__(self, cell: str, ws, bs):
        if cell not in GATES:
            raise ValueError(f"unknown cell {cell!r}")
        if len(ws) != len(GATES[cell]) or len(bs) != len(ws):
            raise ValueError(f"{cell} takes {len(GATES[cell])} weights and "
                             f"biases, got {len(ws)} and {len(bs)}")
        dev, dt = ws[0].device, ws[0].dtype
        if dev.type != "cuda":
            raise ValueError(f"the decode_step kernels need CUDA tensors, "
                             f"got {dev}")
        kl.element_type(ws[0], "weight 0")
        dx, dh = ws[0].shape
        bs = [torch.zeros((dh,), dtype=dt, device=dev) if b is None else b
              for b in bs]
        for i, (w, b) in enumerate(zip(ws, bs)):
            kl.check(w, f"{cell} weight {i}", (dx, dh), dt, dev)
            kl.check(b, f"{cell} bias {i}", (dh,), dt, dev)
        self.cell, self.device, self.dtype, self.dims = cell, dev, dt, (dx, dh)
        self.ws, self.bs = tuple(ws), tuple(bs)
        ptrs = [0] * 7
        if kl.shape_only(ws[0]):
            # a dry run's binding: no address; the allocator's alignment
            self.body, self.ptrs = cell_body(cell, dt, dx, dh, True), ptrs
            return
        self.body = cell_body(cell, dt, dx, dh,
                              all(w.data_ptr() % 16 == 0 for w in ws))
        for i, (w, b) in enumerate(zip(ws, bs)):
            ptrs[1 + i], ptrs[4 + i] = w.data_ptr(), b.data_ptr()
        self.ptrs = ptrs

    @classmethod
    def from_params(cls, params, cell: str, compute_dtype=None):
        """Bind a cell's param dict (``min_gru.init`` / ``min_lstm.init``
        layout), cast to ``compute_dtype`` where given, as the reference
        casts them for its kernel."""
        ws, bs = [], []
        for name in GATES[cell]:
            w, b = params[name]["kernel"], params[name].get("bias")
            if compute_dtype is not None:
                w = w.to(compute_dtype)
                b = None if b is None else b.to(compute_dtype)
            ws.append(w.contiguous())
            bs.append(None if b is None else b.contiguous())
        return cls(cell, ws, bs)

    @property
    def args(self):
        """The bound weights and biases in the wrappers' argument order
        (w0, b0, w1, b1[, w2, b2])."""
        return tuple(t for wb in zip(self.ws, self.bs) for t in wb)


def _bound(cell, ws, bs, operands):
    if operands is None:
        return CellOperands(cell, ws, bs)
    if operands.cell != cell:
        raise ValueError(f"operands were bound for {operands.cell}, the "
                         f"call runs {cell}")
    return operands


def prepare_launch(operands: CellOperands, x, h_prev, valid, *, mode,
                   normalize=True):
    """Check the activations, allocate the output and bind the C call.
    Returns ``(launch, out)``: ``launch()`` issues the kernel on the
    current stream and returns its CUDA status; it does not count.
    x: (B, C, Dx) on CUDA -> out (B, C, Dh) in x's dtype; ``valid`` (B,)
    selects the chunk kernel, None the step kernel (C must be 1)."""
    if mode not in ("log", "linear"):
        raise ValueError(f"unknown mode {mode!r}")
    dev, dt = operands.device, operands.dtype
    dx, dh = operands.dims
    x = x.contiguous()
    if x.data_ptr() % 16:       # a fresh copy is aligned for bulk copies
        x = x.clone()
    bsz, chunk = x.shape[0], x.shape[1]
    kl.check(x, "x", (bsz, chunk, dx), dt, dev)
    h0_f32 = h_prev.dtype != dt
    h0 = (h_prev.float() if h0_f32 else h_prev).contiguous()
    kl.check(h0, "h_prev", (bsz, dh), h0.dtype, dev)
    out = torch.empty((bsz, chunk, dh), dtype=dt, device=dev)
    ptrs = list(operands.ptrs) + [0, 0, 0]
    ptrs[0], ptrs[7], ptrs[9] = x.data_ptr(), h0.data_ptr(), out.data_ptr()
    keep = [operands, x, h0, out]
    lib = _lib()
    if valid is None:
        fn = lib.repro_cell_step_launch
    else:
        valid = valid.to(torch.int32).contiguous()
        kl.check(valid, "valid", (bsz,), torch.int32, dev)
        ptrs[8] = valid.data_ptr()
        keep.append(valid)
        fn = lib.repro_cell_chunk_launch
    args = (int(operands.cell == "minlstm"), int(mode == "log"),
            int(normalize), kl.DTYPES[dt], int(h0_f32), bsz, chunk, dx, dh,
            (ctypes.c_void_p * _N_PTRS)(*ptrs), kl.stream(dev),
            BODIES.index(operands.body))

    def launch(_keep=keep):        # _keep: the operands alive while bound
        return fn(*args)

    # the C entry point and its arguments (``ab.py`` calls another build's)
    launch.entry, launch.args = fn.__name__, args
    return launch, out


def occupancy(operands: CellOperands, bsz: int, chunk: int) -> dict:
    """What a launch of ``operands`` on B = ``bsz`` rows and ``chunk``
    positions would run, from the C launcher's own grid and shared memory
    and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (and, for the
    tensor-core body's clusters, ``cudaOccupancyMaxActiveClusters``):
    {"body", "blocks_per_sm", "grid_blocks", "sms", "cluster" (blocks per
    cluster), "clusters_resident", "waves"}.  Launches nothing."""
    lib = _lib()
    dx, dh = operands.dims
    ptrs = list(operands.ptrs) + [0, 0, 0]
    res = (ctypes.c_int * 5)()
    with torch.cuda.device(operands.device):
        rc = lib.repro_cell_occupancy(
            int(operands.cell == "minlstm"), kl.DTYPES[operands.dtype],
            BODIES.index(operands.body), bsz, chunk, dx, dh,
            (ctypes.c_void_p * _N_PTRS)(*ptrs), res)
    kl.raise_on_error(lib, f"{operands.cell} cell occupancy", rc)
    per_sm, blocks, sms, cluster, clusters = list(res)
    # with clusters, a wave is the clusters resident at once
    n_waves = (waves(blocks // cluster, clusters, 1) if cluster > 1
               else waves(blocks, per_sm, sms))
    return {"body": operands.body, "blocks_per_sm": per_sm,
            "grid_blocks": blocks, "sms": sms, "cluster": cluster,
            "clusters_resident": clusters, "waves": n_waves}


def launches(bsz: int) -> int:
    """The kernel launches one call on ``bsz`` rows makes (the C
    launcher's ``repro_cell_launches``): one, or past ``MAX_TILES`` tiles
    of ``ROWS_PER_TILE`` rows one per ``MAX_TILES`` tiles."""
    tiles = -(-bsz // ROWS_PER_TILE)
    return 1 if tiles <= MAX_TILES else -(-tiles // MAX_TILES)


def work(kernel: str, dtype: torch.dtype, bsz: int, chunk: int, dx: int,
         dh: int, h_dtype: Optional[torch.dtype] = None):
    """(flops, bytes) of one call of ``kernel`` (one of ``KERNELS``) on
    (B, C, Dx) x of ``dtype`` (C 1 for a step): the gate projections'
    multiply-adds; the weights, biases and x read once, h_prev
    (``h_dtype``, default ``dtype``) and, for a chunk, the int32 valid
    lengths read once, the output written once."""
    n_g = len(GATES[kernel.split("_")[0]])
    e = torch.tensor([], dtype=dtype).element_size()
    e_h = torch.tensor([], dtype=h_dtype or dtype).element_size()
    nbytes = e * (n_g * (dx * dh + dh) + bsz * chunk * dx
                  + bsz * chunk * dh) + e_h * bsz * dh
    if "chunk" in kernel:
        nbytes += 4 * bsz
    return 2 * bsz * chunk * n_g * dx * dh, nbytes


def _shape_only(name, operands, x, h_prev, valid):
    """A dry run's call on fake operands: the launch's checks and output,
    its launches and work recorded (``kernels/launch.py``)."""
    dev, dt = operands.device, operands.dtype
    dx, dh = operands.dims
    bsz, chunk = x.shape[0], x.shape[1]
    kl.check(x.contiguous(), "x", (bsz, chunk, dx), dt, dev)
    kl.check(h_prev.contiguous(), "h_prev", (bsz, dh), h_prev.dtype, dev)
    if valid is not None:
        kl.check(valid.to(torch.int32).contiguous(), "valid", (bsz,),
                 torch.int32, dev)
    kl.record(name, launches(bsz),
              work(name, dt, bsz, chunk, dx, dh, h_prev.dtype))
    return torch.empty((bsz, chunk, dh), dtype=dt, device=dev)


def _launch(name, operands, x, h_prev, valid, *, mode, normalize=True):
    if kl.shape_only(x):
        return _shape_only(name, operands, x, h_prev, valid)
    launch, out = prepare_launch(operands, x, h_prev, valid, mode=mode,
                                 normalize=normalize)
    lib = _lib()
    kl.raise_on_error(lib, name, launch())
    # one launch, or past 65,535 tiles of 8 rows one per 65,535 tiles
    n = lib.repro_cell_launches(out.shape[0])
    LAUNCHES[name] += n
    LAUNCHES[f"{name}/{operands.body}"] += n
    return out


def _zeros_for_missing(bs, ws, x):
    return [torch.zeros((w.shape[1],), dtype=x.dtype, device=x.device)
            if b is None else b for w, b in zip(ws, bs)]


def fused_mingru_step(x: torch.Tensor, wz: torch.Tensor,
                      bz: Optional[torch.Tensor], wh: torch.Tensor,
                      bh: Optional[torch.Tensor], h_prev: torch.Tensor, *,
                      mode: str = "log",
                      operands: Optional[CellOperands] = None
                      ) -> torch.Tensor:
    """minGRU cell step in one launch.  x: (..., Dx), h_prev: (..., Dh)
    -> h_t: (..., Dh)."""
    if x.device.type == "cpu":
        bz, bh = _zeros_for_missing((bz, bh), (wz, wh), x)
        return ref.mingru_step_ref(x, wz, bz, wh, bh, h_prev, mode=mode)
    operands = _bound("mingru", (wz, wh), (bz, bh), operands)
    return call_with_flat_lead(
        lambda xf, hf: _launch("mingru_step_kernel", operands,
                               xf.unsqueeze(1), hf, None,
                               mode=mode).select(1, 0),
        (x, 1), (h_prev, 1))


def fused_minlstm_step(x: torch.Tensor, wf: torch.Tensor,
                       bf: Optional[torch.Tensor], wi: torch.Tensor,
                       bi: Optional[torch.Tensor], wh: torch.Tensor,
                       bh: Optional[torch.Tensor], h_prev: torch.Tensor, *,
                       mode: str = "log", normalize: bool = True,
                       operands: Optional[CellOperands] = None
                       ) -> torch.Tensor:
    """minLSTM cell step (three projections, the stable f/(f+i), the
    update) in one launch.  Shapes as :func:`fused_mingru_step`."""
    if x.device.type == "cpu":
        bf, bi, bh = _zeros_for_missing((bf, bi, bh), (wf, wi, wh), x)
        return ref.minlstm_step_ref(x, wf, bf, wi, bi, wh, bh, h_prev,
                                    mode=mode, normalize=normalize)
    operands = _bound("minlstm", (wf, wi, wh), (bf, bi, bh), operands)
    return call_with_flat_lead(
        lambda xf, hf: _launch("minlstm_step_kernel", operands,
                               xf.unsqueeze(1), hf, None, mode=mode,
                               normalize=normalize).select(1, 0),
        (x, 1), (h_prev, 1))


def fused_mingru_chunk(x: torch.Tensor, wz: torch.Tensor,
                       bz: Optional[torch.Tensor], wh: torch.Tensor,
                       bh: Optional[torch.Tensor], h_prev: torch.Tensor,
                       valid: torch.Tensor, *, mode: str = "log",
                       operands: Optional[CellOperands] = None
                       ) -> torch.Tensor:
    """Packed varlen minGRU chunk in one launch: the weights are read once
    for up to C tokens.  x: (..., C, Dx), h_prev: (..., Dh), valid:
    (...,) int in [1, C] -> hs: (..., C, Dh); bit-identical to
    ``valid[b]`` sequential :func:`fused_mingru_step` calls."""
    if x.device.type == "cpu":
        bz, bh = _zeros_for_missing((bz, bh), (wz, wh), x)
        return call_with_flat_lead(
            lambda xf, hf, vf: ref.mingru_chunk_ref(xf, wz, bz, wh, bh, hf,
                                                    vf, mode=mode),
            (x, 2), (h_prev, 1), (valid, 0))
    operands = _bound("mingru", (wz, wh), (bz, bh), operands)
    return call_with_flat_lead(
        lambda xf, hf, vf: _launch("mingru_chunk_kernel", operands, xf, hf,
                                   vf, mode=mode),
        (x, 2), (h_prev, 1), (valid, 0))


def fused_minlstm_chunk(x: torch.Tensor, wf: torch.Tensor,
                        bf: Optional[torch.Tensor], wi: torch.Tensor,
                        bi: Optional[torch.Tensor], wh: torch.Tensor,
                        bh: Optional[torch.Tensor], h_prev: torch.Tensor,
                        valid: torch.Tensor, *, mode: str = "log",
                        normalize: bool = True,
                        operands: Optional[CellOperands] = None
                        ) -> torch.Tensor:
    """Packed varlen minLSTM chunk; contract as :func:`fused_mingru_chunk`."""
    if x.device.type == "cpu":
        bf, bi, bh = _zeros_for_missing((bf, bi, bh), (wf, wi, wh), x)
        return call_with_flat_lead(
            lambda xf, hf, vf: ref.minlstm_chunk_ref(
                xf, wf, bf, wi, bi, wh, bh, hf, vf, mode=mode,
                normalize=normalize),
            (x, 2), (h_prev, 1), (valid, 0))
    operands = _bound("minlstm", (wf, wi, wh), (bf, bi, bh), operands)
    return call_with_flat_lead(
        lambda xf, hf, vf: _launch("minlstm_chunk_kernel", operands, xf, hf,
                                   vf, mode=mode, normalize=normalize),
        (x, 2), (h_prev, 1), (valid, 0))
