"""The paper's own minGRU / minLSTM LMs (Feng et al. 2024, App. C).

Copied from ``repro.configs.archs`` (full and smoke entries); the other
architectures of the reference zoo are not part of this slice.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import MinRNNConfig, ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}
_SMOKE: Dict[str, ModelConfig] = {}

_BIG = dict(param_dtype="bfloat16", compute_dtype="bfloat16", remat="full")
_SMOKE_NUM = dict(param_dtype="float32", compute_dtype="float32",
                  remat="none")


def _register(cfg: ModelConfig, smoke: ModelConfig):
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke


for _name, _cell in (("mingru-lm", "mingru"), ("minlstm-lm", "minlstm")):
    _mr = MinRNNConfig(cell=_cell, expansion=2.0, mode="log",
                       use_conv=True, use_mlp=True)
    _register(
        ModelConfig(name=_name, block_kind="minrnn", n_layers=12,
                    d_model=768, d_ff=3072, vocab_size=256, norm="rmsnorm",
                    tie_embeddings=True, minrnn=_mr, **_BIG),
        ModelConfig(name=_name, block_kind="minrnn", n_layers=3,
                    d_model=64, d_ff=256, vocab_size=256, norm="rmsnorm",
                    tie_embeddings=True, minrnn=_mr, **_SMOKE_NUM))

PAPER_OWN = ["mingru-lm", "minlstm-lm"]


def get(name: str) -> ModelConfig:
    return _REGISTRY[name]


def smoke(name: str) -> ModelConfig:
    return _SMOKE[name]


def all_names():
    return list(_REGISTRY)
