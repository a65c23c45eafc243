"""Config schema: the ported subset of ``repro.configs.base``.

A copy, not an import: the JAX module pulls in ``jax.numpy`` for its
dtype table.  Only the fields the port reads are kept (the minRNN LMs;
the attention trunk: native GQA with RoPE or MLA, dense or with a
leading dense segment and MoE layers, or with its mixer swapped for a minRNN cell by
``seq_mixer``, with RMSNorm or LayerNorm, biased or not, and a stub
patch frontend; the SSD trunk of mamba2; the hybrid SSD trunk with one
shared attention block of zamba2; and the encoder-decoder of whisper
with its stub frame frontend); the field names, defaults and
properties match the reference so a config built here describes the
same model as its JAX twin.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_expert: int                  # per-expert FFN hidden dim
    n_shared: int = 0              # shared (always-on) experts
    d_shared: int = 0              # shared-expert hidden dim (total)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    first_dense_layers: int = 0    # deepseek: leading dense layers
    ep_2d: str = "auto"            # 2D (expert x d) weight sharding of
                                   # the expert-parallel mesh path: on |
                                   # off | auto (models/moe.ep_layout)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 256               # SSD chunk length
    dual_form: str = "masked"      # masked (paper-faithful) | compact

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class MinRNNConfig:
    cell: str = "mingru"           # mingru | minlstm
    expansion: float = 2.0         # paper's alpha (LM uses 2)
    mode: str = "log"              # log-space parameterization
    use_conv: bool = True          # Conv4 prefix (paper App. C.2)
    conv_kernel: int = 4
    use_mlp: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str = "unnamed"
    family: str = "lm"             # lm | encdec (models/encdec.py)
    block_kind: str = "minrnn"     # minrnn | attention | ssm | hybrid
    seq_mixer: str = "native"      # native | mingru | minlstm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 256
    max_seq_len: int = 8192        # the encoder-decoder's dec_pos rows
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_zero_centered: bool = False   # gemma (1 + scale) RMSNorm
    mlp_activation: str = "silu"   # silu | gelu for the (gated) MLP
    gated_mlp: bool = True         # SwiGLU / GeGLU vs plain MLP
    attn_bias: bool = False
    mlp_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    attn_kind: str = "gqa"         # gqa | mla
    # MLA (deepseek-v3): low-rank q / kv, a decoupled RoPE head
    mla_q_lora: int = 1536
    mla_kv_lora: int = 512
    mla_rope_dim: int = 64
    mla_v_dim: int = 128
    mla_qk_nope_dim: int = 128
    tie_embeddings: bool = False
    embedding_scale: bool = False  # gemma: x *= sqrt(d_model)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    minrnn: Optional[MinRNNConfig] = None
    hybrid_attn_every: int = 0     # zamba2: shared attn block period
    # modality frontend stubs: precomputed embeddings projected to d_model
    frontend: Optional[str] = None  # "patches" (vlm) | "frames" (audio)
    n_frontend_tokens: int = 0
    frontend_dim: int = 0           # raw embedding dim of the stub inputs
    n_encoder_layers: int = 0       # encoder-decoder
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # "auto" resolves to the fused kernels (core.scan.resolve_strategy);
    # "sequential" forces the plain PyTorch path (the parity oracle)
    scan_strategy: str = "auto"
    # whole-block decode fusion (kernels/block_step): "auto"/"on" run the
    # block kernel; "off" keeps the cell-only kernel (kernels/decode_step)
    fuse_block: str = "auto"
    logits_softcap: float = 0.0
    # training: per-layer activation checkpointing ("full" recomputes each
    # layer's forward in the backward; "dots" keeps the outputs of its
    # products with no batch dimension and recomputes the rest; "none"
    # keeps its activations) and the z-loss weight on logsumexp(logits)^2
    remat: str = "none"            # none | full | dots
    attn_q_chunk: int = 1024       # blocked-attention tile sizes
    attn_kv_chunk: int = 1024
    z_loss: float = 0.0

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128, as in the reference; pad
        columns are masked to -1e30 in the logits."""
        return -(-self.vocab_size // 128) * 128

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
