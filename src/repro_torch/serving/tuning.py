"""Autotuned plan discovery for the serving engine.

The port of ``repro.serving.tuning``.  ``repro_torch.serving.autotune``
sweeps the decode-path knobs for one model config on one device -- the
decode tier ``fuse_block``, the packed-prefill chunk C and the superstep
decode block K -- and persists the winner as a ``TUNE_*.json`` plan.
This module is the consumer side: the engine resolves a plan at startup
and folds it into its config (``fuse_block``) and scheduling knobs
(``prompt_chunk`` / ``decode_block`` defaults; explicit constructor
arguments always win).  The CUDA kernels plan their own tiles
(``kernels/block_step/ops.plan``), so there is no ``block_dh`` knob.

One deliberate change from the reference: **a plan names the device it
was measured on.**  ``config_stamp`` carries ``"device"``
(``torch.cuda.get_device_name`` for a CUDA device, else ``"cpu"``), the
match keys include it, and the file name ends in the device's slug:
``TUNE_<name>_L<n_layers>_d<d_model>_<slug>.json``, e.g.
``TUNE_mingru-lm_L12_d768_nvidia-h100-80gb-hbm3.json``.  A ranking
measured on one device says nothing about another, so a plan written for
another device (the JAX package's CPU-modelled plans included) is never
picked up by ``"auto"``, and one passed by path raises.

Discovery order for ``resolve_plan(cfg, "auto", device)``:

  1. ``$REPRO_TUNE_DIR/<file name>``
  2. ``./<file name>`` (current working directory)
  3. ``<repo root>/<file name>`` (the checked-in plans)

A discovered plan whose recorded stamp does not match is skipped with a
warning; an explicitly given path raises instead.
"""

from __future__ import annotations

import json
import logging
import os
import re
from pathlib import Path
from typing import Optional, Union

import torch

from repro_torch.device import resolve_device

log = logging.getLogger("repro_torch.tuning")

# src/repro_torch/serving/tuning.py -> repo root
_REPO_ROOT = Path(__file__).resolve().parents[3]

_MATCH_KEYS = ("name", "n_layers", "d_model", "d_ff", "device")


def device_name(device) -> str:
    """The name a plan records for ``device``: the CUDA device's name, or
    ``"cpu"``."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def device_slug(name: str) -> str:
    """``"NVIDIA H100 80GB HBM3"`` -> ``"nvidia-h100-80gb-hbm3"``."""
    return re.sub(r"[^a-z0-9]+", "-", name.lower()).strip("-")


def fingerprint(cfg) -> str:
    return f"{cfg.name}_L{cfg.n_layers}_d{cfg.d_model}"


def tune_filename(cfg, device="cuda") -> str:
    return f"TUNE_{fingerprint(cfg)}_{device_slug(device_name(device))}.json"


def config_stamp(cfg, device="cuda") -> dict:
    """The shape and device fields a plan is valid for."""
    stamp = {k: getattr(cfg, k) for k in _MATCH_KEYS if k != "device"}
    stamp["device"] = device_name(device)
    stamp["compute_dtype"] = cfg.compute_dtype
    return stamp


def plan_matches(plan: dict, cfg, device="cuda") -> bool:
    rec = plan.get("config", {})
    stamp = config_stamp(cfg, device)
    return all(rec.get(k) == stamp[k] for k in _MATCH_KEYS)


def load_plan(path: Union[str, Path]) -> dict:
    with open(path) as f:
        return json.load(f)


def save_plan(path: Union[str, Path], plan: dict) -> None:
    with open(path, "w") as f:
        json.dump(plan, f, indent=2, sort_keys=True)
        f.write("\n")


def search_paths(cfg, device="cuda"):
    name = tune_filename(cfg, device)
    tune_dir = os.environ.get("REPRO_TUNE_DIR")
    if tune_dir:
        yield Path(tune_dir) / name
    yield Path.cwd() / name
    yield _REPO_ROOT / name


def resolve_plan(cfg, tune, device="cuda") -> Optional[dict]:
    """``tune``: None -> no plan; "auto" -> discovery order above; a
    path -> that file (raising on a config or device mismatch); a dict ->
    as-is."""
    if tune is None:
        return None
    if isinstance(tune, dict):
        return tune
    if tune == "auto":
        for p in search_paths(cfg, device):
            if p.is_file():
                plan = load_plan(p)
                if plan_matches(plan, cfg, device):
                    plan.setdefault("source", str(p))
                    return plan
                log.warning(
                    "tune plan %s skipped: recorded config %s does not "
                    "match engine config %s", p, plan.get("config"),
                    config_stamp(cfg, device))
        return None
    plan = load_plan(tune)
    if not plan_matches(plan, cfg, device):
        raise ValueError(
            f"tune plan {tune} was generated for "
            f"{plan.get('config')}, not for {config_stamp(cfg, device)}")
    plan.setdefault("source", str(tune))
    return plan


def apply_plan(cfg, plan: dict):
    """Fold the plan's kernel-level knob (the decode tier) into the model
    config."""
    if plan.get("fuse_block"):
        return cfg.replace(fuse_block=plan["fuse_block"])
    return cfg
