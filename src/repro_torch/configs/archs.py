"""The paper's own minGRU / minLSTM LMs (Feng et al. 2024, App. C),
gemma-2b and gemma-7b (native GQA attention with RoPE), gemma-2b with
the paper's minGRU as its sequence mixer, mamba2-370m (the SSD trunk,
the paper's recurrent rival in Fig. 2), zamba2-2.7b (Mamba-2 layers
with one shared attention block), deepseek-moe-16b (a dense layer,
then routed top-6 experts plus shared ones), starcoder2-15b (LayerNorm,
biased attention and a plain GELU MLP), deepseek-67b (llama-style),
pixtral-12b (a mistral-nemo trunk behind a stub patch frontend),
deepseek-v3-671b (MLA, 3 dense layers, then 256 routed experts top-8
plus a shared one) and whisper-base (the encoder-decoder,
``models/encdec.py``, behind a stub frame frontend).

Copied from ``repro.configs.archs`` (full and smoke entries): every
architecture of the reference's registry.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (MinRNNConfig, ModelConfig, MoEConfig,
                                      SSMConfig)

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
                    d_model=768, d_ff=3072, n_heads=0, n_kv_heads=0,
                    vocab_size=256, norm="rmsnorm", rope=False,
                    tie_embeddings=True, minrnn=_mr, **_BIG),
        ModelConfig(name=_name, block_kind="minrnn", n_layers=3,
                    d_model=64, d_ff=256, n_heads=0, n_kv_heads=0,
                    vocab_size=256, norm="rmsnorm", rope=False,
                    tie_embeddings=True, minrnn=_mr, **_SMOKE_NUM))

# the reference's lists: its assigned zoo, the paper's own LMs, and the
# paper's swap of gemma-2b's attention for minGRU
ASSIGNED = [
    "starcoder2-15b", "gemma-7b", "gemma-2b", "deepseek-67b", "pixtral-12b",
    "mamba2-370m", "deepseek-v3-671b", "deepseek-moe-16b", "whisper-base",
    "zamba2-2.7b",
]
PAPER_OWN = ["mingru-lm", "minlstm-lm"]
EXTRAS = ["gemma-2b-mingru"]

_GEMMA = dict(block_kind="attention", norm="rmsnorm",
              norm_zero_centered=True, gated_mlp=True, mlp_activation="gelu",
              rope=True, tie_embeddings=True, embedding_scale=True)

# gemma-7b [arXiv:2403.08295; hf]: GeGLU, head_dim 256, 256k vocab
_register(
    ModelConfig(name="gemma-7b", n_layers=28, d_model=3072, n_heads=16,
                n_kv_heads=16, head_dim=256, d_ff=24576, vocab_size=256000,
                **_GEMMA, **_BIG),
    ModelConfig(name="gemma-7b", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, head_dim=32, d_ff=128, vocab_size=1024,
                **_GEMMA, **_SMOKE_NUM))

# gemma-2b [arXiv:2403.08295; hf]: MQA (kv 1), GeGLU, head_dim 256
_register(
    ModelConfig(name="gemma-2b", n_layers=18, d_model=2048, n_heads=8,
                n_kv_heads=1, head_dim=256, d_ff=16384, vocab_size=256000,
                **_GEMMA, **_BIG),
    ModelConfig(name="gemma-2b", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=1, head_dim=32, d_ff=128, vocab_size=1024,
                **_GEMMA, **_SMOKE_NUM))

# gemma-2b with the paper's minGRU replacing attention (the reference's
# beyond-paper model), derived from gemma-2b as the reference derives it
_g2_mr = MinRNNConfig(cell="mingru", expansion=1.0, mode="log",
                      use_conv=False, use_mlp=False)
_register(
    _REGISTRY["gemma-2b"].replace(name="gemma-2b-mingru", seq_mixer="mingru",
                                  minrnn=_g2_mr),
    _SMOKE["gemma-2b"].replace(name="gemma-2b-mingru", seq_mixer="mingru",
                               minrnn=_g2_mr))

# mamba2-370m [arXiv:2405.21060]: SSD, attention-free, tied vocab 50280
_register(
    ModelConfig(
        name="mamba2-370m", block_kind="ssm",
        n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab_size=50280, norm="rmsnorm", rope=False, tie_embeddings=True,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                      conv_kernel=4, chunk=256), **_BIG),
    ModelConfig(
        name="mamba2-370m", block_kind="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab_size=512, norm="rmsnorm", rope=False, tie_embeddings=True,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1,
                      conv_kernel=4, chunk=8), **_SMOKE_NUM))

# deepseek-moe-16b [arXiv:2401.06066; hf]: 2 shared + 64 routed top-6
_register(
    ModelConfig(
        name="deepseek-moe-16b", block_kind="attention",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=10944, vocab_size=102400, norm="rmsnorm", gated_mlp=True,
        mlp_activation="silu", rope=True,
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                      d_shared=2816, first_dense_layers=1,
                      capacity_factor=1.25), **_BIG),
    ModelConfig(
        name="deepseek-moe-16b", block_kind="attention",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, norm="rmsnorm", gated_mlp=True,
        mlp_activation="silu", rope=True,
        # capacity >= N*k so the smoke consistency tests see no dropping
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=2,
                      d_shared=64, first_dense_layers=1,
                      capacity_factor=16.0), **_SMOKE_NUM))

# deepseek-v3-671b [arXiv:2412.19437; hf]: MLA, 1 shared + 256 routed
# experts top-8 after 3 dense layers (the MTP head left out, as in the
# reference)
_register(
    ModelConfig(
        name="deepseek-v3-671b", block_kind="attention", attn_kind="mla",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=18432, vocab_size=129280, norm="rmsnorm", gated_mlp=True,
        mlp_activation="silu", rope=True,
        mla_q_lora=1536, mla_kv_lora=512, mla_rope_dim=64,
        mla_qk_nope_dim=128, mla_v_dim=128,
        moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                      d_shared=2048, first_dense_layers=3,
                      capacity_factor=1.25), **_BIG),
    ModelConfig(
        name="deepseek-v3-671b", block_kind="attention", attn_kind="mla",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, norm="rmsnorm", gated_mlp=True,
        mlp_activation="silu", rope=True,
        mla_q_lora=32, mla_kv_lora=16, mla_rope_dim=8,
        mla_qk_nope_dim=16, mla_v_dim=16,
        # capacity >= N*k so the smoke consistency tests see no dropping
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                      d_shared=32, first_dense_layers=1,
                      capacity_factor=16.0), **_SMOKE_NUM))

# zamba2-2.7b [arXiv:2411.15242; hf]: Mamba2 trunk + one shared attention
# block applied every 6 layers (the shared-block LoRA omitted, as in the
# reference)
_register(
    ModelConfig(
        name="zamba2-2.7b", block_kind="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=10240, vocab_size=32000, norm="rmsnorm", gated_mlp=True,
        mlp_activation="gelu", rope=True, hybrid_attn_every=6,
        ssm=SSMConfig(d_state=64, expand=2, head_dim=64, n_groups=1,
                      conv_kernel=4, chunk=256), **_BIG),
    ModelConfig(
        name="zamba2-2.7b", block_kind="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, norm="rmsnorm", gated_mlp=True,
        mlp_activation="gelu", rope=True, hybrid_attn_every=2,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1,
                      conv_kernel=4, chunk=8), **_SMOKE_NUM))

# starcoder2-15b [arXiv:2402.19173; hf]: GQA, RoPE, LayerNorm, plain GELU
# MLP, biases on attention and MLP
_register(
    ModelConfig(
        name="starcoder2-15b", block_kind="attention",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
        d_ff=24576, vocab_size=49152, norm="layernorm", gated_mlp=False,
        mlp_activation="gelu", attn_bias=True, mlp_bias=True,
        rope=True, rope_theta=1e5, tie_embeddings=False, **_BIG),
    ModelConfig(
        name="starcoder2-15b", block_kind="attention",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, norm="layernorm", gated_mlp=False,
        mlp_activation="gelu", attn_bias=True, mlp_bias=True,
        rope=True, rope_theta=1e5, **_SMOKE_NUM))

# deepseek-67b [arXiv:2401.02954; hf]: llama-style, GQA kv 8, SwiGLU
_register(
    ModelConfig(
        name="deepseek-67b", block_kind="attention",
        n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22016, vocab_size=102400, norm="rmsnorm", gated_mlp=True,
        mlp_activation="silu", rope=True, **_BIG),
    ModelConfig(
        name="deepseek-67b", block_kind="attention",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=512, norm="rmsnorm", gated_mlp=True,
        mlp_activation="silu", rope=True, **_SMOKE_NUM))

# pixtral-12b [hf:mistralai/Pixtral-12B-2409]: the pixtral-ViT frontend as
# a stub (precomputed patch embeddings, projected) before a mistral-nemo
# trunk
_register(
    ModelConfig(
        name="pixtral-12b", block_kind="attention",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=131072, norm="rmsnorm", gated_mlp=True,
        mlp_activation="silu", rope=True, rope_theta=1e6,
        frontend="patches", n_frontend_tokens=1024, frontend_dim=1024,
        **_BIG),
    ModelConfig(
        name="pixtral-12b", block_kind="attention",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, norm="rmsnorm", gated_mlp=True,
        mlp_activation="silu", rope=True, rope_theta=1e6,
        frontend="patches", n_frontend_tokens=8, frontend_dim=32,
        **_SMOKE_NUM))

# whisper-base [arXiv:2212.04356]: encoder-decoder behind a stub frame
# frontend (precomputed frame embeddings, projected)
_register(
    ModelConfig(
        name="whisper-base", family="encdec", block_kind="attention",
        n_layers=6, n_encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=51865, norm="layernorm",
        gated_mlp=False, mlp_activation="gelu", attn_bias=True,
        mlp_bias=True, rope=False, frontend="frames",
        n_frontend_tokens=1500, frontend_dim=512, max_seq_len=32768,
        **_BIG),
    ModelConfig(
        name="whisper-base", family="encdec", block_kind="attention",
        n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, norm="layernorm",
        gated_mlp=False, mlp_activation="gelu", attn_bias=True,
        mlp_bias=True, rope=False, frontend="frames",
        n_frontend_tokens=16, frontend_dim=32, max_seq_len=128,
        **_SMOKE_NUM))


def get(name: str) -> ModelConfig:
    return _REGISTRY[name]


def smoke(name: str) -> ModelConfig:
    return _SMOKE[name]


def all_names():
    return list(_REGISTRY)
