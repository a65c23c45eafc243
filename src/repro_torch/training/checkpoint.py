"""Fault-tolerant checkpointing, in the reference's on-disk format
(``repro.training.checkpoint``), so checkpoints cross between the two
packages in both directions.

Layout: ``<dir>/step_<%08d>/arrays.npz + manifest.json``, written to a
``.tmp`` directory and renamed over the final one (a crash mid-save never
corrupts the previous good checkpoint).  Trees are flattened to keys
``params|layers|blocks|...`` (and ``mu|...``, ``nu|...``, ``opt_step``),
so restore needs no pickled structure.  bf16 leaves are stored as a
uint16 view and listed under ``dtypes`` in the manifest; ``checksum`` is
the sha256 of ``arrays.npz``, verified on restore.
``CheckpointManager.restore_latest`` walks checkpoints newest first and
falls back past corrupt ones.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.bridge import leaf_from_numpy
from repro_torch.device import resolve_device
from repro_torch.training.optimizer import AdamWState
from repro_torch.tree import leaves_with_path, tree_map

log = logging.getLogger("repro_torch.checkpoint")

SEP = "|"


class CheckpointCorruptError(RuntimeError):
    """arrays.npz does not match the manifest checksum (or is missing)."""


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor -> numpy; bf16 as its uint16 bit pattern."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def flatten_tree(tree, prefix: str) -> Dict[str, Any]:
    """Nested dict -> {``prefix|k1|k2``: leaf}."""
    return {SEP.join((prefix,) + tuple(str(k) for k in path)): leaf
            for path, leaf in leaves_with_path(tree)}


def unflatten_tree(flat: Dict[str, Any], prefix: str):
    """Rebuild a nested dict from path keys under ``prefix``."""
    root: Dict[str, Any] = {}
    pl = prefix + SEP
    for key, val in flat.items():
        if not key.startswith(pl):
            continue
        parts = key[len(pl):].split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def pack_arrays(arrays: Dict[str, torch.Tensor]):
    """npz-safe packing: bf16 leaves as a uint16 view.  Returns
    ``(packed, dtypes)``; ``dtypes`` goes in the manifest."""
    packed, dtypes = {}, {}
    for k, v in arrays.items():
        packed[k] = _to_numpy(v)
        dtypes[k] = "bfloat16" if v.dtype == torch.bfloat16 \
            else str(packed[k].dtype)
    return packed, dtypes


def unpack_arrays(raw, dtypes: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_arrays` over a loaded npz (CPU tensors)."""
    out = {}
    for k in raw.files:
        v = raw[k]
        if dtypes.get(k) == "bfloat16":
            out[k] = torch.from_numpy(v.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out[k] = leaf_from_numpy(v)
    return out


@contextlib.contextmanager
def atomic_dir(final: str):
    """Yield a tmp directory that atomically replaces ``final`` when the
    block completes."""
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    yield tmp
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def save(directory: str, step: int, params, opt_state=None,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomic checkpoint write.  Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    arrays = flatten_tree(params, "params")
    manifest = {"step": step, "time": time.time(), "extra": extra or {}}
    if opt_state is not None:
        arrays.update(flatten_tree(opt_state.mu, "mu"))
        arrays.update(flatten_tree(opt_state.nu, "nu"))
        arrays["opt_step"] = opt_state.step
        manifest["has_opt"] = True
    packed, dtypes = pack_arrays(arrays)
    manifest["dtypes"] = dtypes
    with atomic_dir(final) as tmp:
        np.savez(os.path.join(tmp, "arrays.npz"), **packed)
        manifest["checksum"] = "sha256:" + sha256_file(
            os.path.join(tmp, "arrays.npz"))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    return final


def verify(path: str) -> bool:
    """True iff the checkpoint's content hash matches its manifest
    (checkpoints without a ``checksum`` field verify trivially)."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    recorded = manifest.get("checksum")
    if recorded is None:
        return os.path.exists(os.path.join(path, "arrays.npz"))
    try:
        return recorded == "sha256:" + sha256_file(
            os.path.join(path, "arrays.npz"))
    except OSError:
        return False


def _load_arrays(path: str):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    recorded = manifest.get("checksum")
    if recorded is not None:
        actual = "sha256:" + sha256_file(os.path.join(path, "arrays.npz"))
        if actual != recorded:
            raise CheckpointCorruptError(
                f"{path}: arrays.npz hash {actual} != manifest {recorded}")
    with np.load(os.path.join(path, "arrays.npz")) as raw:
        arrays = unpack_arrays(raw, manifest["dtypes"])
    return arrays, manifest


def _to(tree, dev):
    return tree_map(lambda t: t.to(dev), tree)


def restore(path: str, *, device="cuda"):
    """Returns (step, params, opt_state or None), on ``device``."""
    dev = resolve_device(device)
    flat, manifest = _load_arrays(path)
    params = _to(unflatten_tree(flat, "params"), dev)
    opt_state = None
    if manifest.get("has_opt"):
        opt_state = AdamWState(
            step=flat["opt_step"].to(torch.int32).to(dev),
            mu=_to(unflatten_tree(flat, "mu"), dev),
            nu=_to(unflatten_tree(flat, "nu"), dev))
    return manifest["step"], params, opt_state


def all_steps(directory: str):
    """Completed checkpoint steps in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


class CheckpointManager:
    """keep-N garbage collection + optional background-thread saves;
    restores land on ``device``."""

    def __init__(self, directory: str, keep: int = 3,
                 save_interval: int = 100, async_save: bool = False,
                 device="cuda"):
        self.directory = directory
        self.keep = keep
        self.save_interval = save_interval
        self.async_save = async_save
        self.device = device
        self._thread: Optional[threading.Thread] = None
        self.corrupt_skipped: list = []   # steps restore_latest fell past

    def maybe_save(self, step: int, params, opt_state=None, force=False):
        if not force and (step == 0 or step % self.save_interval != 0):
            return False
        self.wait()
        if self.async_save:
            # snapshot to the host before handing off to the thread: the
            # optimizer updates the device tensors in place
            host_p = _to(params, "cpu")
            host_o = opt_state if opt_state is None else AdamWState(
                opt_state.step.cpu(), _to(opt_state.mu, "cpu"),
                _to(opt_state.nu, "cpu"))
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, host_p, host_o))
            self._thread.start()
        else:
            self._save_and_gc(step, params, opt_state)
        return True

    def _save_and_gc(self, step, params, opt_state):
        save(self.directory, step, params, opt_state)
        for s in all_steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self):
        """Restore the newest checkpoint that passes verification,
        falling back past corrupt ones (recorded in ``corrupt_skipped``).
        Returns None when none is restorable."""
        for step in reversed(all_steps(self.directory)):
            path = os.path.join(self.directory, f"step_{step:08d}")
            try:
                return restore(path, device=self.device)
            except (CheckpointCorruptError, OSError, ValueError,
                    KeyError) as e:
                self.corrupt_skipped.append(step)
                log.warning("checkpoint %s unrestorable (%s); "
                            "falling back", path, e)
        return None
