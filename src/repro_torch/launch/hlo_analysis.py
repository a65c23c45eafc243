"""Per-rank costs of a traced step: collective bytes, roofline terms, model
FLOPs and the kernels' bounds (the port of ``repro.launch.hlo_analysis``).

The reference parses the compiled per-device HLO.  The port has none: a
rank's step runs eagerly on fake tensors under :class:`Recorder`, a
``TorchDispatchMode`` that sees every op this rank dispatches -- the
``c10d`` collectives of a fake world included -- and keeps what the HLO
text gave: each collective's kind and per-rank RESULT bytes, summed as
``repro.launch.hlo_analysis.collective_stats`` sums them; the bytes each
op reads and writes; and the peak of the live storages' bytes.  The
kernels of the repo are no ops: their wrappers record their launches and
work (``kernels/launch.py``: ``Tally``; each kernel's ``ops.work``).

The roofline constants are the NVIDIA H100 SXM 80GB HBM3 data sheet's, at
its 700 W power limit (dense rates, no sparsity).
"""

from __future__ import annotations

import weakref
from typing import Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

CARD = "NVIDIA H100 80GB HBM3 (SXM data sheet, 700 W)"
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card, dense
# fp32 runs outside the tensor cores
PEAK_FLOPS_BY_DTYPE = {torch.float32: 67e12, torch.bfloat16: PEAK_FLOPS}
HBM_BW = 3.35e12             # bytes/s per card
HBM_BYTES = 80e9             # the card's memory, for ``fits``
# NVLink 4: 900 GB/s per card (both directions) inside an 8-card node.
# A 16-rank model axis spans two 8-GPU nodes, so part of its traffic
# crosses the network instead, at a fraction of this: t_collective is a
# lower bound there.
LINK_BW = 900e9

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute", "broadcast")
# c10d op name prefix -> kind (first match wins)
_C10D = (("allreduce", "all-reduce"), ("reduce_scatter", "reduce-scatter"),
         ("_reduce_scatter", "reduce-scatter"), ("allgather", "all-gather"),
         ("_allgather", "all-gather"), ("alltoall", "all-to-all"),
         ("broadcast", "broadcast"), ("send", "collective-permute"),
         ("recv", "collective-permute"))
# ops that allocate without writing
_EMPTY = ("empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "empty_permuted")


def collective_kind(func):
    """The kind of a ``c10d`` op (None for any other op, or a barrier)."""
    if func.namespace != "c10d":
        return None
    name = func.overloadpacket.__name__
    for prefix, kind in _C10D:
        if name.startswith(prefix):
            return kind
    return None


def _tensors(x):
    """The tensors in an op's (nested list / tuple / dict) arguments."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


class Recorder(TorchDispatchMode):
    """What one rank's traced step does, op by op:

    * ``collectives``: (kind, result bytes) per ``c10d`` op, its result
      being its first argument (the tensors it writes);
    * ``bytes``: every other op's tensor inputs read once and outputs
      written once, views and allocations excepted;
    * ``live`` / ``peak``: bytes of the storages alive, from those
      :meth:`track` registers (the step's arguments) and every op's
      outputs, each freed when its storage is.
    """

    def __init__(self):
        super().__init__()
        self.collectives = []
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._storages = {}

    def _free(self, key, n):
        self.live -= n
        self._storages.pop(key, None)

    def track(self, tree):
        """Count the storages of ``tree``'s tensors as live."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = collective_kind(func)
        if kind is not None:
            self.collectives.append((kind, _nbytes(args[0])))
        elif not func.is_view and \
                func.overloadpacket.__name__ not in _EMPTY:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        self.track(out)
        return out


def collective_stats(records: Iterable[Tuple[str, int]]
                     ) -> Dict[str, Dict[str, float]]:
    """Per-collective-kind {count, bytes} from ``Recorder.collectives``."""
    stats = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    for kind, nbytes in records:
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += nbytes
    return stats


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   collective_bytes_per_dev: float) -> Dict[str, float]:
    """The three per-device roofline times (seconds)."""
    t_compute = flops_per_dev / PEAK_FLOPS
    t_memory = bytes_per_dev / HBM_BW
    t_collective = collective_bytes_per_dev / LINK_BW
    dominant = max(
        [("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)], key=lambda kv: kv[1])[0]
    return {"t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_collective, "dominant": dominant}


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6*N*D for training, 2*N*D for inference (fwd only)."""
    mult = 6 if kind == "train" else 2
    return float(mult) * n_params_active * tokens


def kernel_bound_ms(work: Tuple[int, int], dtype: torch.dtype):
    """(least ms, "bytes" or "operations") for a kernel call's ``work``
    (an ``ops.work`` (flops, bytes)): its bytes over the memory rate
    against its FLOPs over ``dtype``'s peak, the larger."""
    flops, nbytes = work
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK_FLOPS_BY_DTYPE[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")
