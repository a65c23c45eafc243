"""Decoder-only LM: the minRNN LMs, the attention trunk (native GQA
with RoPE and a KV cache, e.g. gemma-2b, or MLA with a latent cache;
with a leading dense segment and mixture-of-experts layers,
deepseek-moe-16b and deepseek-v3-671b; or, dense or MoE, its mixer
swapped for a minRNN cell by ``seq_mixer``, e.g. gemma-2b-mingru), the
SSD trunk (mamba2-370m) and the hybrid trunk (zamba2-2.7b: SSD layers
with one shared attention block applied after every
``hybrid_attn_every`` of them; with an MLA or minRNN mixer it trains
only, as in the reference), trained, prefilled and served -- the models
of ``repro.models.lm``.

Params are nested dicts with the JAX pytree's layout -- ``embed.table``,
``final_norm.scale`` and ``layers.blocks.*`` stacked with a leading L
axis (the MoE trunk's leading dense layers under
``layers.dense_blocks``, its MoE layers carrying ``moe`` in place of
``mlp``; the hybrid's shared block under ``layers.shared_attn``) -- so
the bridge, the checkpoints and the parity tests line up leaf by leaf.
``MinRNNLM`` is a thin ``nn.Module`` around such a dict whose floating
leaves are ``nn.Parameter``s (``.to(device)``, ``state_dict``,
``parameters()``).

Training runs ``forward`` / ``loss_fn``: the layer stack of
``blocks.apply`` or of attention blocks (the fused CUDA cell kernel in
every minRNN layer or mixer under the default strategy; GQA's and MLA's
blocked attention, the MoE layer and the SSD mixer in PyTorch ops, as
the reference runs them outside Pallas), each layer -- each group of SSD
layers and the shared block, in the hybrid -- under
``torch.utils.checkpoint`` when ``cfg.remat`` is "full" or "dots"; the MoE
layers' router loss joins the loss.  ``prefill`` runs the same parallel
form over a prompt (right-padded batches; the minRNN trunk resumable
from a cache) and hands a cache to the decode functions: one fused-cell
launch per minRNN layer, a KV cache seeded with the prompt's keys and
values, or the SSD layers' conv windows and fp32 states
(``models/ssd.py``), or both (the hybrid).

Serving drives the step forms: ``superstep`` runs K rounds of
re-admission -> token select -> ``decode_step`` (or ``decode_chunk`` for
packed prefill) -> sample-or-teacher-force -> retire over device-resident
per-slot state (``init_slot_state``); with a draft source it runs the
speculative rounds instead (``_superstep_spec``: propose, one
``decode_verify`` chunk pass, accept, roll back by a gather).  The
reference runs those rounds in one ``lax.scan``; here they are a Python
loop of eager device ops.  Each minRNN layer of each round is ONE launch
of the whole-block CUDA kernel, or, on the cell-fused tier
(``fuse_block="off"``) and in every layer of an attention trunk with a
minRNN mixer, one launch of the cell-only CUDA kernel between PyTorch
norms, projections and MLPs.  Native GQA decodes in PyTorch ops against
a KV cache written in place (``attention._cache_insert``), MLA in its
latent space against a ``ckv`` / ``krope`` cache, every norm and product
of an attention trunk's step in tiles of ``attention.DECODE_ROWS`` rows
(a minRNN cell steps all B rows in one launch; the MoE layer routes all
B tokens together, as the reference's does); the SSD and
hybrid trunks step in groups of ``attention.DECODE_ROWS`` rows
(``_ssm_decode``).
A ``frontend="patches"`` config (pixtral-12b) prepends projected stub
patch embeddings to the token embeddings (``patch_embeds`` of
``forward``, ``loss_fn``'s batch and ``prefill``); the encoder-decoder
(``family="encdec"``, whisper-base) is ``models/encdec.py``.
Whoever owns the params binds them once (``bind_layers``) and passes the
binding as ``layers=``; without it, each call binds its own.  The prefill
and decode functions run under ``torch.no_grad()``: they build no graph
(the fused cells save nothing), whether or not the params require
grad.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.utils.checkpoint

from repro_torch.core import blocks as minrnn_blocks
from repro_torch.core import min_gru, min_lstm, nn
from repro_torch.core import scan as scan_lib
from repro_torch.device import fake_mode, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.tree import leaves, tree_map

_MIN_CELLS = {"mingru": min_gru, "minlstm": min_lstm}


# ===========================================================================
# Parameters
# ===========================================================================

def _minrnn_block_cfg(cfg) -> minrnn_blocks.MinRNNBlockConfig:
    mr = cfg.minrnn
    return minrnn_blocks.MinRNNBlockConfig(
        d_model=cfg.d_model, cell=mr.cell, expansion=mr.expansion,
        use_conv=mr.use_conv, conv_kernel=mr.conv_kernel,
        use_mlp=mr.use_mlp, mlp_factor=cfg.d_ff / cfg.d_model,
        mode=mr.mode, norm=cfg.norm, scan_strategy=cfg.scan_strategy,
        fuse_block=cfg.fuse_block)


def _check_cfg(cfg):
    """The minRNN trunk; the attention trunk with native GQA or MLA or a
    minRNN mixer (dense, or a dense prefix and MoE layers); the SSD
    trunk; the hybrid SSD trunk with a shared GQA, MLA or minRNN block
    (served with GQA only: ``_check_serves``).  The encoder-decoder
    family is another module."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name} is an encoder-decoder (family 'encdec'): its "
            f"model is models/encdec.py (training.train_step.model_for "
            f"picks it)")
    if cfg.block_kind == "minrnn" or _attn_native(cfg) or _ssm(cfg) \
            or _attn_minrnn(cfg):
        return
    if _hybrid(cfg):
        if cfg.n_layers % cfg.hybrid_attn_every:
            raise ValueError(
                f"the hybrid trunk needs n_layers ({cfg.n_layers}) to be a "
                f"multiple of hybrid_attn_every ({cfg.hybrid_attn_every})")
        return
    what = f"block_kind {cfg.block_kind!r}"
    if cfg.block_kind in ("attention", "hybrid"):
        what = f"the {cfg.seq_mixer} {cfg.attn_kind} mixer of block_kind " \
               f"{cfg.block_kind!r} (hybrid_attn_every " \
               f"{cfg.hybrid_attn_every})"
    raise NotImplementedError(
        f"{what} is not a model of the reference; the port runs the "
        f"minRNN LMs, attention trunks with native GQA or MLA or a mingru "
        f"/ minlstm seq_mixer (dense or MoE), the SSD trunk and the hybrid "
        f"SSD trunk with a shared GQA, MLA or minRNN block every "
        f"hybrid_attn_every > 0 layers")


def _check_serves(cfg):
    """``_check_cfg``, and the decode state exists: the hybrid's shared
    block decodes and prefills against a KV cache, so with an MLA or
    minRNN mixer it trains only -- the reference's serving reads that
    block's ``k`` / ``v`` (``src/repro/models/lm.py:1220``, ``:1437``) and
    fails on such a config."""
    _check_cfg(cfg)
    if _hybrid(cfg) and not _native_gqa(cfg):
        raise NotImplementedError(
            f"the hybrid trunk with a shared {cfg.seq_mixer} "
            f"{cfg.attn_kind} block trains only: its cache, decode, prefill "
            f"and serving read the shared block's KV cache, as the "
            f"reference's do (src/repro/models/lm.py:1220 and :1437 fail "
            f"on this config with a KeyError)")


def _ssm(cfg) -> bool:
    """The SSD trunk (mamba2): norm -> SSD mixer -> residual per layer."""
    return cfg.block_kind == "ssm"


def _native_gqa(cfg) -> bool:
    return cfg.seq_mixer == "native" and cfg.attn_kind == "gqa"


def _hybrid(cfg) -> bool:
    """The hybrid trunk (zamba2): SSD layers, and one shared attention
    block (params shared, KV caches not) after every
    ``hybrid_attn_every`` of them; its mixer native GQA or, as the
    reference's ``_mixer_apply`` takes them, MLA or a minRNN cell."""
    return cfg.block_kind == "hybrid" and cfg.hybrid_attn_every > 0 \
        and (cfg.seq_mixer in _MIN_CELLS
             or (cfg.seq_mixer == "native"
                 and cfg.attn_kind in ("gqa", "mla")))


def _attn_minrnn(cfg) -> bool:
    """The attention trunk with its mixer swapped for a minRNN cell."""
    return cfg.block_kind == "attention" and cfg.seq_mixer in _MIN_CELLS


def _attn_native(cfg) -> bool:
    """The attention trunk with its native mixer: GQA (a KV cache) or MLA
    (a latent cache), its MLP dense or, after ``moe.first_dense_layers``
    dense layers, MoE."""
    return cfg.block_kind == "attention" and cfg.seq_mixer == "native" \
        and cfg.attn_kind in ("gqa", "mla")


def _kv_keys(cfg):
    """The attention trunk's per-position cache leaves: MLA's latent
    ``ckv`` and rotary key ``krope``, or GQA's ``k`` and ``v``."""
    return ("ckv", "krope") if cfg.attn_kind == "mla" else ("k", "v")


def _mixer_d_hidden(cfg) -> int:
    exp = cfg.minrnn.expansion if cfg.minrnn else 1.0
    return int(cfg.d_model * exp)


def kernel_tier(cfg) -> str:
    """The decode tier the layers run: "block-fused" (one whole-block
    kernel launch per layer per round), "cell-fused" (one cell-only
    kernel launch per layer per round, the rest PyTorch ops; always so on
    an attention trunk with a minRNN mixer) or "unfused" (plain PyTorch;
    always so for native GQA or MLA, dense or MoE, and the SSD and
    hybrid trunks, as the reference engine reports them)."""
    _check_cfg(cfg)
    if _attn_native(cfg) or _ssm(cfg) or _hybrid(cfg):
        return "unfused"
    if _attn_minrnn(cfg):
        return "cell-fused" if scan_lib.resolve_strategy(
            cfg.scan_strategy) == "fused" else "unfused"
    return minrnn_blocks.fuse_block_tier(_minrnn_block_cfg(cfg))


def tree_to(tree, device):
    """Move every leaf of a param / state tree to ``device``; a tree
    already there comes back as it is."""
    dev = torch.device(device)
    if all(a.device.type == dev.type
           and (dev.index is None or a.device.index == dev.index)
           for a in leaves(tree)):
        return tree
    return tree_map(lambda a: a.to(dev), tree)


def init_params(gen: torch.Generator, cfg, device="cuda") -> Dict[str, Any]:
    """Seeded random init in the reference's layout, drawn on ``gen``'s
    device (a CUDA generator draws on the card: gemma-2b-mingru's 2.5 B
    weights are too many for a quick host-side draw), then moved to
    ``device``.  The numbers differ from ``jax.random``'s; tests that
    compare the two packages bridge the JAX weights instead."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    dtype = cfg.pdtype
    params: Dict[str, Any] = {
        "embed": {"table": nn.normal_init(
            gen, (cfg.padded_vocab, cfg.d_model), 0.02, dtype)},
        "final_norm": nn.norm_init(cfg.norm, cfg.d_model, dtype),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = nn.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                          use_bias=False, dtype=dtype)
    if cfg.frontend == "patches":
        params["patch_proj"] = nn.dense_init(gen, cfg.frontend_dim,
                                             cfg.d_model, use_bias=False,
                                             dtype=dtype)
    if cfg.block_kind == "attention":
        # a leading dense segment before the MoE layers (deepseek)
        n_dense = cfg.moe.first_dense_layers if cfg.moe else 0
        params["layers"] = {}
        if n_dense:
            params["layers"]["dense_blocks"] = _stack_init(
                lambda: _attn_layer_init(gen, cfg, dtype, force_dense=True),
                n_dense)
        params["layers"]["blocks"] = _stack_init(
            lambda: _attn_layer_init(gen, cfg, dtype),
            cfg.n_layers - n_dense)
    elif _ssm(cfg) or _hybrid(cfg):
        params["layers"] = {"blocks": _stack_init(
            lambda: {"norm": nn.norm_init(cfg.norm, cfg.d_model, dtype),
                     "mixer": ssd_lib.ssd_init(gen, cfg, dtype=dtype)},
            cfg.n_layers)}
        if _hybrid(cfg):
            params["layers"]["shared_attn"] = _attn_layer_init(
                gen, cfg, dtype, force_dense=True)
    else:
        bc = _minrnn_block_cfg(cfg)
        params["layers"] = {"blocks": _stack_init(
            lambda: minrnn_blocks.init(gen, bc, dtype=dtype), cfg.n_layers)}
    return tree_to(params, dev)


def _stack_init(make, n: int):
    """``stack([make() for _ in range(n)])`` -- the same draws in the same
    order -- holding one layer's tree beside the stack at a time, not all
    n: deepseek-moe-16b's 32.75 GB of bf16 weights fit the card once, not
    twice, and deepseek-v3-671b's two 23 GB MoE layers with one more.
    One layer is its own stack (views, no copy); n = 0 draws one layer
    for the shapes and keeps none (an empty MoE stack).  A fake trace
    (``launch/input_specs.py``) makes one layer: the stack's shapes."""
    layer = make()
    if n == 1:
        return tree_map(lambda a: a.unsqueeze(0), layer)
    out = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), layer)
    if fake_mode() is not None:
        return out
    for i in range(n):
        if i:
            layer = make()
        for dst, src in zip(leaves(out), leaves(layer)):
            dst[i].copy_(src)
        layer = None
    return out


def _mixer_init(gen, cfg, dtype):
    """The attention block's sequence mixer: GQA, MLA, or a minRNN cell
    and its down projection (the reference's ``_mixer_init``)."""
    if cfg.seq_mixer not in _MIN_CELLS:
        init = attn.mla_init if cfg.attn_kind == "mla" else attn.gqa_init
        return init(gen, cfg, dtype=dtype)
    cell = _MIN_CELLS[cfg.seq_mixer]
    dh = _mixer_d_hidden(cfg)
    return {"rnn": cell.init(gen, cfg.d_model, dh, dtype=dtype),
            "down": nn.dense_init(gen, dh, cfg.d_model, use_bias=False,
                                  dtype=dtype)}


def _attn_layer_init(gen, cfg, dtype, force_dense: bool = False):
    p = {"norm1": nn.norm_init(cfg.norm, cfg.d_model, dtype),
         "mixer": _mixer_init(gen, cfg, dtype),
         "norm2": nn.norm_init(cfg.norm, cfg.d_model, dtype)}
    if cfg.moe and not force_dense:
        p["moe"] = moe_lib.moe_init(gen, cfg, dtype=dtype)
    else:
        p["mlp"] = mlp_lib.mlp_init(gen, cfg.d_model, cfg.d_ff,
                                    gated=cfg.gated_mlp, bias=cfg.mlp_bias,
                                    dtype=dtype)
    return p


class _Tree(torch.nn.Module):
    """One level of a param dict: sub-dicts are child modules, floating
    tensors are ``nn.Parameter``s (trainable), any other leaf a buffer, so
    ``state_dict`` keys are the dotted JAX paths."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            elif v.is_floating_point():
                self.register_parameter(k, torch.nn.Parameter(v))
            else:
                self.register_buffer(k, v)

    def tree(self) -> dict:
        out = dict(self._parameters)
        out.update(self._buffers)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class MinRNNLM(torch.nn.Module):
    """Holds an LM's params for ``.to(device)`` / ``state_dict``;
    ``params()`` returns the nested dict the functions here take."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        _check_cfg(cfg)
        self.cfg = cfg
        self.tree = _Tree(params)

    def params(self) -> dict:
        return self.tree.tree()


def bind_layers(params, cfg) -> List[tuple]:
    """``(params, operands)`` per layer: views of the stacked layer params
    and each layer's weights bound for its kernel -- the whole block
    (``blocks.bind``) or, on the cell-fused tier and the attention trunk's
    minRNN mixer, the cell's gates (``CellOperands``); None on the CPU and
    for native GQA (dense or MoE) and the SSD and hybrid trunks, which run
    no kernel (the hybrid's layers are its SSD layers).  Bind once per
    params and pass the result as ``layers=``; it reads the params as they
    are now, so bind again after replacing a leaf."""
    _check_cfg(cfg)
    out = []
    with torch.no_grad():
        if _ssm(cfg) or _hybrid(cfg):
            return [(p_l, None) for p_l in _layer_params(params)]
        if cfg.block_kind == "attention":
            cell_tier = kernel_tier(cfg) == "cell-fused"
            for p_l in _layer_params(params):
                ops_ = None
                if cell_tier and leaves(p_l)[0].device.type == "cuda":
                    from repro_torch.kernels.decode_step import ops as so
                    ops_ = so.CellOperands.from_params(
                        p_l["mixer"]["rnn"], cfg.seq_mixer, cfg.cdtype)
                out.append((p_l, ops_))
            return out
        bc = _minrnn_block_cfg(cfg)
        for p_l in _layer_params(params):
            out.append((p_l, minrnn_blocks.bind(p_l, bc,
                                                compute_dtype=cfg.cdtype)))
    return out


def _layer_params(params) -> List[dict]:
    """Views of the stacked block params, one dict per layer: the MoE
    trunk's dense layers first, then its MoE layers, as the reference
    runs them (the hybrid's shared block is not among them)."""
    out = []
    for key in ("dense_blocks", "blocks"):
        blocks = params["layers"].get(key)
        if blocks is not None:
            out += unstack(blocks)
    return out


def unstack(stack) -> List[dict]:
    """Views of a stacked layer tree (a leading layer axis), one dict per
    layer."""
    n = leaves(stack)[0].shape[0]
    return [tree_map(lambda a, i=i: a[i], stack) for i in range(n)]


# ===========================================================================
# Embedding / logits
# ===========================================================================

def _embed(params, cfg, tokens: torch.Tensor,
           patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings; with a patch frontend and ``patch_embeds`` (B, P,
    frontend_dim), the projected patches first: (B, P + S, d)."""
    x = params["embed"]["table"].to(cfg.cdtype)[tokens.long()]
    if cfg.embedding_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype)
    if cfg.frontend == "patches" and patch_embeds is not None:
        pe = nn.dense_apply(params["patch_proj"], patch_embeds, cfg.cdtype)
        x = torch.cat([pe.to(x.dtype), x], dim=1)
    return x


def _logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].to(cfg.cdtype).T
    else:
        logits = nn.dense_apply(params["unembed"], x, cfg.cdtype)
    if cfg.logits_softcap:
        logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
    return mask_pad_vocab(cfg, logits)


def mask_pad_vocab(cfg, logits: torch.Tensor) -> torch.Tensor:
    """The pad columns past ``cfg.vocab_size`` set to -1e30."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    col = torch.arange(cfg.padded_vocab, device=logits.device)
    return torch.where(col < cfg.vocab_size, logits,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device))


def _final(params, cfg, x):
    return _logits(params, cfg, _norm(cfg, params["final_norm"], x))


def _row_groups(x: torch.Tensor):
    """(start, rows, x[start:start + rows] padded with zero rows to
    ``attention.DECODE_ROWS``) for each group of rows of x."""
    size = attn.DECODE_ROWS
    for i in range(0, x.shape[0], size):
        part = x[i:i + size]
        n = part.shape[0]
        yield i, n, part if n == size else nn.pad_to(part, size)


def _final_rows(params, cfg, x):
    """``_final`` in groups of ``attention.DECODE_ROWS`` rows: a row's
    logits do not depend on how many rows came with it."""
    return nn.tiled(lambda t: _final(params, cfg, t), x, attn.DECODE_ROWS)


# ===========================================================================
# Trunk (parallel) / forward / loss
# ===========================================================================

# the products ``remat="dots"`` keeps: those with no batch dimension (a
# 2D weight times the rows), as ``dots_with_no_batch_dims_saveable``
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(cfg, fn):
    """``remat="full"``: recompute the layer's forward in the backward
    (``torch.utils.checkpoint``, non-reentrant; a block draws no random
    numbers, so no RNG state is stashed).  ``remat="dots"``: the same,
    keeping the outputs of the products with no batch dimension
    (``aten.mm`` / ``addmm``: the projections, the MLP, the logits) and
    recomputing everything else -- batched products (``aten.bmm``: the
    attention scores, the experts), elementwise ops and the hand-written
    kernels -- the counterpart of the reference's
    ``jax.checkpoint(policy=dots_with_no_batch_dims_saveable)``.  Neither
    changes a value, only what the backward keeps."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "dots":
        kw = {"context_fn": _dots_context}
    else:
        raise ValueError(f"remat {cfg.remat!r}: 'none', 'full' or 'dots'")
    return lambda *args: torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def _mixer_apply(p, cfg, x, positions):
    """The attention block's mixer over a sequence: the minRNN cell's
    parallel form (the fused kernel under the default strategy) and its
    down projection, or causal GQA or MLA."""
    if cfg.seq_mixer in _MIN_CELLS:
        cell = _MIN_CELLS[cfg.seq_mixer]
        mode = cfg.minrnn.mode if cfg.minrnn else "log"
        h = cell.parallel(p["rnn"], x, mode=mode, compute_dtype=cfg.cdtype,
                          scan_strategy=cfg.scan_strategy)
        return nn.dense_apply(p["down"], h, cfg.cdtype)
    if cfg.attn_kind == "mla":
        return attn.mla_apply(p, cfg, x, positions=positions, causal=True)
    return attn.gqa_apply(p, cfg, x, positions=positions, causal=True)


def _norm(cfg, p, x):
    nk = dict(zero_centered=True) if cfg.norm_zero_centered else {}
    return nn.norm_apply(cfg.norm, p, x, **nk)


def _ffn(p, cfg, y, rows=None):
    """The block's feed-forward half on y (B, S, d) or, at a decode step,
    (B, d): the MLP or, in an MoE layer, the routed and shared experts
    over every token given.  ``rows``: every product in tiles of that many
    rows.  Returns (out, the router's aux loss: 0 for an MLP, None at a
    step, which drops it)."""
    if "moe" in p:
        step = y.ndim == 2
        out, aux = moe_lib.moe_apply(p["moe"], cfg,
                                     y[:, None, :] if step else y,
                                     activation=cfg.mlp_activation, rows=rows,
                                     with_aux=not step)
        return (out[:, 0] if step else out), aux
    out = nn.tiled(lambda t: mlp_lib.mlp_apply(
        p["mlp"], t, activation=cfg.mlp_activation,
        compute_dtype=cfg.cdtype), y, rows)
    return out, torch.zeros((), dtype=torch.float32, device=y.device)


def _attn_block_apply(p, cfg, x, positions):
    """Returns (x, the MoE layer's aux loss; 0 for a dense layer)."""
    x = x + _mixer_apply(p["mixer"], cfg, _norm(cfg, p["norm1"], x),
                         positions)
    out, aux = _ffn(p, cfg, _norm(cfg, p["norm2"], x))
    return x + out, aux


def _ssm_block_apply(p, cfg, x):
    return x + ssd_lib.ssd_block_apply(p["mixer"], cfg,
                                       _norm(cfg, p["norm"], x))


def _trunk_apply(params, cfg, x: torch.Tensor):
    """The layer stack in the parallel form, each layer under ``_remat``:
    ``blocks.apply`` per minRNN layer, an attention block at positions
    ``arange(T)`` (the dense layers, then the MoE layers), or an SSD
    block; the hybrid in groups (``_hybrid_apply``).  Returns (x, the MoE
    layers' aux losses summed; 0 without MoE)."""
    _check_cfg(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _hybrid(cfg):
        return _hybrid_apply(params, cfg, x), aux
    if _ssm(cfg):
        def body(x_, p_l):
            return _ssm_block_apply(p_l, cfg, x_)
    elif cfg.block_kind == "attention":
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        body = _remat(cfg, lambda x_, p_l: _attn_block_apply(
            p_l, cfg, x_, positions))
        for p_l in _layer_params(params):
            x, aux_l = body(x, p_l)
            if "moe" in p_l:
                aux = aux + aux_l
        return x, aux
    else:
        bc = _minrnn_block_cfg(cfg)

        def body(x_, p_l):
            return minrnn_blocks.apply(p_l, bc, x_, compute_dtype=cfg.cdtype,
                                       scan_strategy=cfg.scan_strategy)

    body = _remat(cfg, body)
    for p_l in _layer_params(params):
        x = body(x, p_l)
    return x, aux


def _hybrid_apply(params, cfg, x):
    """The hybrid trunk: per group, ``hybrid_attn_every`` SSD blocks and
    then the shared attention block (its params shared by every group,
    its activations not).  The remat unit is the group, as the
    reference's."""
    every = cfg.hybrid_attn_every
    blocks = _layer_params(params)
    shared = params["layers"]["shared_attn"]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def group(x_, shared_p, *p_group):
        for p_l in p_group:
            x_ = _ssm_block_apply(p_l, cfg, x_)
        return _attn_block_apply(shared_p, cfg, x_, positions)[0]

    group = _remat(cfg, group)
    for g in range(0, len(blocks), every):
        x = group(x, shared, *blocks[g:g + every])
    return x


def forward(params, cfg, tokens: torch.Tensor, *,
            patch_embeds: Optional[torch.Tensor] = None):
    """tokens: (B, S) -> (logits (B, S*, V) in the compute dtype, aux
    loss): the MoE layers' router loss summed over the layers, fp32
    (zero without MoE).  S* counts a patch prefix (``patch_embeds``)."""
    x = _embed(params, cfg, tokens, patch_embeds)
    x, aux = _trunk_apply(params, cfg, x)
    return _final(params, cfg, x), aux


def loss_fn(params, cfg, batch: Dict[str, torch.Tensor]):
    """batch: tokens (B, S), labels (B, S) with -1 = ignore, optional
    patch_embeds (whose prefix's logits are dropped) -> (loss, metrics):
    the token-mean NLL in fp32, plus ``cfg.z_loss`` x the mean squared
    logsumexp and, with MoE, ``router_aux_weight`` x the router loss
    (``moe_aux``).  Metrics are detached."""
    tokens, labels = batch["tokens"], batch["labels"]
    logits, aux = forward(params, cfg, tokens,
                          patch_embeds=batch.get("patch_embeds"))
    if logits.shape[1] != labels.shape[1]:      # a frontend prefix
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    logits = logits.float()
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    metrics = {"nll": loss.detach(), "ntokens": mask.sum()}
    if cfg.z_loss:
        zl = cfg.z_loss * (logz ** 2 * mask).sum() / denom
        loss = loss + zl
        metrics["z_loss"] = zl.detach()
    if cfg.moe:
        loss = loss + cfg.moe.router_aux_weight * aux
        metrics["moe_aux"] = aux.detach()
    metrics["loss"] = loss.detach()
    return loss, metrics


# ===========================================================================
# Decode
# ===========================================================================

def init_cache(cfg, batch: int, max_len: int, device="cuda") -> Dict[str, Any]:
    """Stacked per-layer recurrent state, or KV cache (L, B, max_len, KV,
    head_dim), or MLA's latent cache ``ckv`` (L, B, max_len, kv_lora) and
    ``krope`` (L, B, max_len, rope_dim), + per-row position counter.  The SSD trunk's: ``conv``
    (L, B, K-1, d_inner + 2 G N) in the compute dtype and ``ssm`` (L, B,
    H, P, N) in fp32; the hybrid's: those for its L SSD layers and ``k`` /
    ``v`` (n_groups, B, max_len, KV, head_dim), one per application of
    the shared GQA block (``_check_serves``)."""
    _check_serves(cfg)
    dev = resolve_device(device)
    dt = cfg.cdtype
    pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if _ssm(cfg) or _hybrid(cfg):
        st = ssd_lib.ssd_block_init_state(cfg, batch, dt, dev)
        cache = {"pos": pos, **{k: torch.stack([v] * cfg.n_layers)
                                for k, v in st.items()}}
        if _hybrid(cfg):
            shape = (cfg.n_layers // cfg.hybrid_attn_every, batch, max_len,
                     cfg.n_kv_heads, cfg.head_dim_)
            cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
            cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
        return cache
    if _attn_minrnn(cfg):
        return {"pos": pos, "h": torch.zeros(
            (cfg.n_layers, batch, _mixer_d_hidden(cfg)), dtype=dt,
            device=dev)}
    if _attn_native(cfg):
        if cfg.attn_kind == "mla":
            shapes = {"ckv": (cfg.mla_kv_lora,), "krope": (cfg.mla_rope_dim,)}
        else:
            kv = (cfg.n_kv_heads, cfg.head_dim_)
            shapes = {"k": kv, "v": kv}
        return {"pos": pos, **{
            k: torch.zeros((cfg.n_layers, batch, max_len) + s, dtype=dt,
                           device=dev) for k, s in shapes.items()}}
    bc = _minrnn_block_cfg(cfg)
    cache: Dict[str, Any] = {
        "pos": pos,
        "h": torch.zeros((cfg.n_layers, batch, bc.d_hidden), dtype=dt,
                         device=dev)}
    if bc.use_conv:
        cache["conv"] = torch.zeros(
            (cfg.n_layers, batch, bc.conv_kernel - 1, cfg.d_model),
            dtype=dt, device=dev)
    return cache


def _run_layers(params, cfg, x, cache, block_fn, layers):
    bc = _minrnn_block_cfg(cfg)
    if layers is None:
        layers = bind_layers(params, cfg)
    hs, convs = [], []
    for i, (p_l, operands) in enumerate(layers):
        state = {"h": cache["h"][i]}
        if bc.use_conv:
            state["conv"] = cache["conv"][i]
        x, state = block_fn(p_l, bc, x, state, operands)
        hs.append(state["h"])
        if bc.use_conv:
            convs.append(state["conv"])
    outs = {"h": torch.stack(hs)}
    if bc.use_conv:
        outs["conv"] = torch.stack(convs)
    return x, outs


def _minrnn_decode(params, cfg, x, cache, layers=None):
    """The layer stack for one token: ``blocks.step`` per layer -- one
    whole-block kernel launch each under the default strategy."""
    return _run_layers(
        params, cfg, x, cache,
        lambda p, bc, x_, st, ops_: minrnn_blocks.step(
            p, bc, x_, st, compute_dtype=cfg.cdtype, operands=ops_),
        layers)


def _attn_mixer_step(p, cfg, y, cache_l, pos, operands, tables=None):
    """The mixer for one token, with this layer's cache dict: the minRNN
    cell (its kernel under the default strategy; ``operands`` its
    binding) and the down projection, or GQA against the KV cache or MLA
    against its latent cache (the new entries written in place, every
    product in tiles of ``attention.DECODE_ROWS`` rows; ``tables`` the
    step's ``attention.decode_tables``).  Returns (out, new mixer cache
    dict)."""
    if cfg.seq_mixer not in _MIN_CELLS:
        step = attn.mla_decode_step if cfg.attn_kind == "mla" \
            else attn.gqa_decode_step
        keys = _kv_keys(cfg)
        out, a, b = step(p, cfg, y, cache_l[keys[0]], cache_l[keys[1]], pos,
                         tables=tables, rows=attn.DECODE_ROWS)
        return out, {keys[0]: a, keys[1]: b}
    cell = _MIN_CELLS[cfg.seq_mixer]
    mode = cfg.minrnn.mode if cfg.minrnn else "log"
    h = cell.step(p["rnn"], y, cache_l["h"], mode=mode,
                  compute_dtype=cfg.cdtype,
                  scan_strategy=cfg.scan_strategy, operands=operands)
    out = nn.tiled(lambda t: nn.dense_apply(p["down"], t, cfg.cdtype), h,
                   attn.DECODE_ROWS)
    return out, {"h": h}


def _attn_block_step(p, cfg, x, cache_l, pos, operands, tables=None):
    """One attention block for one token.  The norms and every product
    run in tiles of ``attention.DECODE_ROWS`` rows, so a row's result
    does not depend on B (an MoE layer routes all B rows together, as
    the reference's does at a step); a minRNN cell steps all B rows in
    one launch, each row on its own."""
    rows = attn.DECODE_ROWS
    y = nn.tiled(lambda t: _norm(cfg, p["norm1"], t), x, rows)
    out, mix_cache = _attn_mixer_step(p["mixer"], cfg, y, cache_l, pos,
                                      operands, tables)
    x = x + out
    y = nn.tiled(lambda t: _norm(cfg, p["norm2"], t), x, rows)
    out, _ = _ffn(p, cfg, y, rows)
    return x + out, mix_cache


def _attn_decode(params, cfg, x, cache, layers=None):
    """The attention trunk for one token: per layer norm, mixer, residual,
    norm, MLP (or MoE), residual -- one cell-kernel launch per layer with
    a minRNN mixer; with GQA or MLA, each layer's cache rows (k / v, or
    ckv / krope) written in place into the stacked cache, which comes
    back as it is."""
    if layers is None:
        layers = bind_layers(params, cfg)
    pos = cache["pos"]
    if _attn_native(cfg):
        keys = _kv_keys(cfg)
        # built once for every layer of the step
        tables = attn.decode_tables(
            cfg, pos, cache[keys[0]].shape[2],
            cfg.mla_rope_dim if cfg.attn_kind == "mla" else None)
        for i, (p_l, _) in enumerate(layers):
            x, _ = _attn_block_step(p_l, cfg, x, {k: cache[k][i]
                                                  for k in keys},
                                    pos, None, tables)
        return x, {k: cache[k] for k in keys}
    hs = []
    for i, (p_l, operands) in enumerate(layers):
        x, mc = _attn_block_step(p_l, cfg, x, {"h": cache["h"][i]}, pos,
                                 operands)
        hs.append(mc["h"])
    return x, {"h": torch.stack(hs)}


@torch.no_grad()
def decode_step(params, cfg, token: torch.Tensor, cache: Dict[str, Any], *,
                layers=None):
    """token: (B,) -> (logits (B, V), new cache).  ``layers``: the
    params' ``bind_layers``, if the caller holds one.  A KV cache's ``k``
    / ``v`` are updated in place and come back in the new cache (the
    reference returns new arrays of the same values)."""
    _check_serves(cfg)
    new_cache = dict(cache)
    new_cache["pos"] = cache["pos"] + 1
    if _ssm(cfg) or _hybrid(cfg):
        logits, outs = _ssm_decode(params, cfg, token, cache, layers)
        new_cache.update(outs)
        return logits, new_cache
    x = _embed(params, cfg, token)
    decode = _attn_decode if cfg.block_kind == "attention" else _minrnn_decode
    x, outs = decode(params, cfg, x, cache, layers)
    new_cache.update(outs)
    final = _final_rows if cfg.block_kind == "attention" else _final
    return final(params, cfg, x), new_cache


def _ssm_decode(params, cfg, token, cache, layers=None):
    """The SSD and hybrid trunks for one token: per layer norm,
    ``ssd_block_step``, residual -- in the hybrid, after every
    ``hybrid_attn_every`` layers the shared attention block against its
    group's KV cache (written in place) --; then the final norm and
    logits.  The rows run in groups of ``attention.DECODE_ROWS``, the last
    group padded with zero rows (and, in the hybrid, its KV rows copied
    out and back), so every product of the step (the projections, the
    state read-out, the attention, the logits) runs at one row count
    whatever B is, and a row's result does not depend on B (the engine's
    greedy streams equal ``generate_one``'s, B 1, only so).  Returns
    (logits (B, V), {"conv", "ssm"[, "k", "v"]})."""
    if layers is None:
        layers = bind_layers(params, cfg)
    rows = attn.DECODE_ROWS
    every = cfg.hybrid_attn_every if _hybrid(cfg) else 0
    logits, convs, ssms = [], [], []
    for i, n, tok in _row_groups(token):
        conv, ssm = cache["conv"][:, i:i + n], cache["ssm"][:, i:i + n]
        if every:
            k_g, v_g = cache["k"][:, i:i + n], cache["v"][:, i:i + n]
            pos = cache["pos"][i:i + n]
        if n < rows:
            conv, ssm = (nn.pad_to(a, rows, 1) for a in (conv, ssm))
            if every:
                k_g, v_g = (nn.pad_to(a, rows, 1) for a in (k_g, v_g))
                pos = nn.pad_to(pos, rows)
        if every:
            tables = attn.decode_tables(cfg, pos, k_g.shape[2])
        x = _embed(params, cfg, tok)
        conv_l, ssm_l = [], []
        for li, (p_l, _) in enumerate(layers):
            out, st = ssd_lib.ssd_block_step(
                p_l["mixer"], cfg, _norm(cfg, p_l["norm"], x),
                {"conv": conv[li], "ssm": ssm[li]})
            x = x + out
            conv_l.append(st["conv"][:n])
            ssm_l.append(st["ssm"][:n])
            if every and (li + 1) % every == 0:
                g = li // every
                x, _ = _attn_block_step(
                    params["layers"]["shared_attn"], cfg, x,
                    {"k": k_g[g], "v": v_g[g]}, pos, None, tables)
        if every and n < rows:          # the padded copy's rows back
            cache["k"][:, i:i + n] = k_g[:, :n]
            cache["v"][:, i:i + n] = v_g[:, :n]
        logits.append(_final(params, cfg, x)[:n])
        convs.append(torch.stack(conv_l))
        ssms.append(torch.stack(ssm_l))
    kv = {"k": cache["k"], "v": cache["v"]} if every else {}
    if len(logits) == 1:
        return logits[0], {"conv": convs[0], "ssm": ssms[0], **kv}
    return torch.cat(logits), {"conv": torch.cat(convs, dim=1),
                               "ssm": torch.cat(ssms, dim=1), **kv}


def supports_prompt_packing(cfg) -> bool:
    """True when the superstep can consume C > 1 prompt tokens per round:
    the whole decode state is a constant-size recurrence."""
    return cfg.block_kind == "minrnn"


@torch.no_grad()
def decode_chunk(params, cfg, tokens: torch.Tensor, valid: torch.Tensor,
                 cache: Dict[str, Any], *, layers=None):
    """Packed varlen step: tokens (B, C), valid (B,) int32 in [1, C] ->
    (logits (B, V) at each row's position ``valid[b]-1``, new cache), per
    token identical to ``valid[b]`` sequential ``decode_step`` calls."""
    if not supports_prompt_packing(cfg):
        raise NotImplementedError(
            f"packed decode_chunk requires block_kind='minrnn', got "
            f"{cfg.block_kind!r}")
    x = _embed(params, cfg, tokens)                    # (B, C, D)
    x, outs = _run_layers(
        params, cfg, x, cache,
        lambda p, bc, x_, st, ops_: minrnn_blocks.step_chunk(
            p, bc, x_, st, valid, compute_dtype=cfg.cdtype, operands=ops_),
        layers)
    new_cache = dict(cache)
    new_cache.update(outs)
    x_last = nn.gather_last(x, valid)                  # (B, D) at valid-1
    new_cache["pos"] = cache["pos"] + valid.to(torch.int32)
    return _final(params, cfg, x_last), new_cache


@torch.no_grad()
def decode_verify(params, cfg, tokens: torch.Tensor, valid: torch.Tensor,
                  cache: Dict[str, Any], *, layers=None):
    """Speculative-verify pass: tokens (B, W), valid (B,) int32 in [1, W]
    -> (logits (B, W, V), per-position states {"h": (L, B, W, Dh)[,
    "conv": (L, B, W, K-1, D)]}).

    ``decode_chunk``'s sibling: the same masked varlen replay, one chunk
    kernel launch per layer, per token identical to ``valid[b]``
    sequential ``decode_step`` calls, keeping what verification needs --
    the logits at every position and the state after every position.
    The caller commits ``valid_eff[b] <= valid[b]`` positions by
    gathering the states at ``valid_eff[b] - 1``; positions at or past
    ``valid[b]`` re-emit the frozen state, so any index in
    ``[valid_eff - 1, W)`` is safe.  ``cache`` is left as it is."""
    if cfg.block_kind != "minrnn":
        raise NotImplementedError(
            f"decode_verify requires a constant-size recurrent state "
            f"(block_kind='minrnn'), got {cfg.block_kind!r}")
    bc = _minrnn_block_cfg(cfg)
    if layers is None:
        layers = bind_layers(params, cfg)
    x = _embed(params, cfg, tokens)                    # (B, W, D)
    pos = {"h": []}
    if bc.use_conv:
        pos["conv"] = []
    for i, (p_l, operands) in enumerate(layers):
        state = {k: cache[k][i] for k in pos}
        x, _, pos_l = minrnn_blocks.step_chunk(
            p_l, bc, x, state, valid, compute_dtype=cfg.cdtype,
            return_positions=True, operands=operands)
        for k in pos:
            pos[k].append(pos_l[k])
    # the final norm and logits a position at a time, as decode_step runs
    # them (see blocks.step_chunk): the logits equal the steps' bit for bit
    logits = torch.stack([_final(params, cfg, x[:, t].contiguous())
                          for t in range(x.shape[1])], dim=1)
    return logits, {k: torch.stack(v) for k, v in pos.items()}


# ===========================================================================
# Prefill: one parallel pass over the prompt that seeds the decode cache
# ===========================================================================

def supports_chunked_prefill(cfg) -> bool:
    """True when ``prefill`` can resume from a carried cache: the whole
    decode state is a constant-size recurrence of the minRNN trunk (the
    SSD trunk would need a state-resumed chunk scan, as in the
    reference)."""
    return cfg.block_kind == "minrnn"


def _attn_block_prefill(p, cfg, x, positions, *, lengths=None):
    """The attention trunk's block over the prompt: with a minRNN mixer
    the cell's parallel form (the fused kernel under the default
    strategy) and the down product, with GQA causal blocked attention;
    then the MLP, or the MoE layer over every token of the batch, pad
    tokens too, as the reference's.  Returns (x, the mixer's cache: h at
    each row's last real position, or the prompt's k / v -- MLA's ckv /
    krope -- at every position)."""
    y = _norm(cfg, p["norm1"], x)
    if cfg.seq_mixer not in _MIN_CELLS:
        fn = attn.mla_prefill if cfg.attn_kind == "mla" else attn.gqa_prefill
        out, a, b = fn(p["mixer"], cfg, y, positions=positions)
        mix_cache = dict(zip(_kv_keys(cfg), (a, b)))
    else:
        cell = _MIN_CELLS[cfg.seq_mixer]
        mode = cfg.minrnn.mode if cfg.minrnn else "log"
        h = cell.parallel(p["mixer"]["rnn"], y, mode=mode,
                          compute_dtype=cfg.cdtype,
                          scan_strategy=cfg.scan_strategy)
        out = nn.dense_apply(p["mixer"]["down"], h, cfg.cdtype)
        mix_cache = {"h": h[:, -1] if lengths is None
                     else nn.gather_last(h, lengths)}
    x = x + out
    out, _ = _ffn(p, cfg, _norm(cfg, p["norm2"], x))
    return x + out, mix_cache


def _seed_kv(full: List[torch.Tensor], max_len: int) -> torch.Tensor:
    """L x (B, T, ...) prompt kv -> (L, B, max_len, ...), zero past T."""
    first = full[0]
    out = first.new_zeros((len(full), first.shape[0], max_len)
                          + tuple(first.shape[2:]))
    for i, a in enumerate(full):
        out[i, :, :a.shape[1]] = a
    return out


@torch.no_grad()
def prefill(params, cfg, tokens: torch.Tensor, max_len: int, *,
            patch_embeds: Optional[torch.Tensor] = None,
            lengths: Optional[torch.Tensor] = None,
            cache: Optional[Dict[str, Any]] = None):
    """Parallel prompt processing: tokens (B, T) -> (last-token logits
    (B, V), a cache ``decode_step`` / ``superstep`` take as it is).  The
    prompt is one parallel scan per layer -- one fused-cell kernel launch
    under the default strategy -- not T sequential cell evaluations.

    ``lengths`` (B,) int32: right-padded prompts, row b's logits and
    state taken at its position ``lengths[b] - 1``.  ``cache``: resume
    from an earlier prefill's cache (chunked prefill; the minRNN trunk
    only).  ``pos`` advances by the tokens consumed.  The SSD layers'
    padded positions are inert steps (dt 0), so their state is the state
    after ``lengths[b]`` tokens.  ``max_len`` sizes a
    KV cache: the prompt's keys and values at positions [0, T), zeros
    after; a padded row's positions past its length hold the pad's, which
    decode overwrites before it can attend to them.  An MoE layer routes
    the pad tokens too, as the reference's: where assignments drop, a
    padded row need not equal its own prefill.  ``patch_embeds``: a patch
    prefix before the tokens, its keys and values seeded into the cache
    at positions [0, P); ``lengths`` is refused with a patch frontend, as
    in the reference."""
    _check_serves(cfg)
    if cache is not None and not supports_chunked_prefill(cfg):
        raise NotImplementedError(
            f"chunked prefill resume not supported for block_kind="
            f"{cfg.block_kind!r}")
    if lengths is not None and cfg.frontend == "patches":
        raise NotImplementedError("variable-length prefill with a patch "
                                  "frontend prefix is not supported")
    x = _embed(params, cfg, tokens, patch_embeds)
    bsz, t = x.shape[0], x.shape[1]
    if (_attn_native(cfg) or _hybrid(cfg)) and t > max_len:
        raise ValueError(f"prompt of {t} tokens exceeds max_len {max_len}")
    consumed = torch.full((bsz,), t, dtype=torch.int32, device=x.device) \
        if lengths is None else lengths.to(torch.int32)
    new_cache: Dict[str, Any] = {
        "pos": consumed if cache is None else cache["pos"] + consumed}
    if _ssm(cfg):
        states = {"conv": [], "ssm": []}
        for p_l in _layer_params(params):
            out, st = ssd_lib.ssd_block_apply(
                p_l["mixer"], cfg, _norm(cfg, p_l["norm"], x),
                return_state=True, lengths=lengths)
            x = x + out
            for k in states:
                states[k].append(st[k])
        new_cache.update({k: torch.stack(v) for k, v in states.items()})
    elif _hybrid(cfg):
        x, cache_h = _hybrid_prefill(params, cfg, x, max_len, lengths)
        new_cache.update(cache_h)
    elif cfg.block_kind == "attention":
        positions = torch.arange(t, device=x.device)[None, :]
        mcs = []
        for p_l in _layer_params(params):
            x, mc = _attn_block_prefill(p_l, cfg, x, positions,
                                        lengths=lengths)
            mcs.append(mc)
        if _attn_native(cfg):
            for k in _kv_keys(cfg):
                new_cache[k] = _seed_kv([mc[k] for mc in mcs], max_len)
        else:
            new_cache["h"] = torch.stack([mc["h"] for mc in mcs])
    else:
        bc = _minrnn_block_cfg(cfg)
        keys = ("h", "conv") if bc.use_conv else ("h",)
        states = {k: [] for k in keys}
        for i, p_l in enumerate(_layer_params(params)):
            state0 = None if cache is None else {k: cache[k][i]
                                                 for k in keys}
            x, st = minrnn_blocks.apply(
                p_l, bc, x, state0=state0, lengths=lengths,
                compute_dtype=cfg.cdtype, scan_strategy=cfg.scan_strategy,
                return_state=True)
            for k in keys:
                states[k].append(st[k])
        new_cache.update({k: torch.stack(v) for k, v in states.items()})
    x_last = x[:, -1] if lengths is None else nn.gather_last(x, lengths)
    if _ssm(cfg) or _hybrid(cfg):    # as their decode: a row's logits
        return _final_rows(params, cfg, x_last), new_cache     # whatever B
    return _final(params, cfg, x_last), new_cache


def _hybrid_prefill(params, cfg, x, max_len, lengths=None):
    """The hybrid trunk over the prompt: the SSD layers' conv windows and
    states after each row's ``lengths[b]`` tokens, and one KV cache per
    application of the shared block.  Returns (x, {"conv", "ssm", "k",
    "v"})."""
    every = cfg.hybrid_attn_every
    shared = params["layers"]["shared_attn"]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    states = {"conv": [], "ssm": []}
    mcs = []
    for li, p_l in enumerate(_layer_params(params)):
        out, st = ssd_lib.ssd_block_apply(
            p_l["mixer"], cfg, _norm(cfg, p_l["norm"], x),
            return_state=True, lengths=lengths)
        x = x + out
        for k in states:
            states[k].append(st[k])
        if (li + 1) % every == 0:
            x, mc = _attn_block_prefill(shared, cfg, x, positions,
                                        lengths=lengths)
            mcs.append(mc)
    out = {k: torch.stack(v) for k, v in states.items()}
    for k in ("k", "v"):
        out[k] = _seed_kv([mc[k] for mc in mcs], max_len)
    return x, out


# ===========================================================================
# Superstep: prefill + decode + sampling + re-admission, K rounds
# ===========================================================================

# cache leaves read back by the recurrence, zeroed when a slot re-arms.
# KV leaves (k / v, MLA's ckv / krope) stay in place, as in the
# reference: decode masks attention by the row's ``pos`` and writes
# position p before attending to it, so stale entries past ``pos`` are
# never seen
_RECURRENT_CACHE_KEYS = ("h", "conv", "ssm")

# request fields swapped wholesale from the staging buffer when a row arms
_ARM_FIELDS = ("prompt_len", "rid", "remaining", "eos", "temperature",
               "top_k", "top_p")


def init_slot_state(cfg, batch: int, max_len: int, *, seed: int = 0,
                    draft=None, device="cuda") -> Dict[str, Any]:
    """Device-resident per-slot serving state for ``superstep`` (layout of
    the reference's ``init_slot_state``).  The per-slot PRNG key data
    ``keys`` (B, 2) lives on the host as int64 holding uint32 values;
    ``key_lag`` (on the device) counts each slot's emissions since those
    keys were last advanced -- the chain is caught up lazily, only when a
    sampled request needs it (``serving.sampling``).

    ``draft`` (a ``serving.draft`` source) adds the speculative state:
    ``n_out`` (tokens emitted, appended to the prompt buffer as drafting
    history) and the source's own per-slot state
    (``draft.extra_state``, e.g. the draft model's decode cache)."""
    from repro_torch.serving import sampling

    dev = resolve_device(device)

    def iv(fill=0):
        return torch.full((batch,), fill, dtype=torch.int32, device=dev)

    def fv(fill):
        return torch.full((batch,), fill, dtype=torch.float32, device=dev)

    def bv():
        return torch.zeros((batch,), dtype=torch.bool, device=dev)

    def prompt():
        return torch.zeros((batch, max_len), dtype=torch.int32, device=dev)

    state = {
        "cache": init_cache(cfg, batch, max_len, dev),
        "tok": iv(), "alive": bv(),
        "keys": sampling.make_keys(seed, batch), "key_lag": iv(),
        "prompt": prompt(), "prompt_len": iv(), "prompt_pos": iv(),
        "rid": iv(-1), "remaining": iv(), "eos": iv(-1),
        "temperature": fv(0.0), "top_k": iv(), "top_p": fv(1.0),
        "s_valid": bv(), "s_prompt": prompt(),
        "s_prompt_len": iv(), "s_rid": iv(-1), "s_remaining": iv(),
        "s_eos": iv(-1), "s_temperature": fv(0.0), "s_top_k": iv(),
        "s_top_p": fv(1.0),
    }
    if draft is not None:
        state["n_out"] = iv()
        state.update(draft.extra_state(batch, max_len, dev))
    return state


def _reset_slot_rows(cache: Dict[str, Any], mask: torch.Tensor):
    """Re-arm rows ``mask``: zero their recurrent state and position."""
    out = dict(cache)
    out["pos"] = torch.where(mask, 0, cache["pos"])
    for name in _RECURRENT_CACHE_KEYS:
        if name in cache:
            leaf = cache[name]
            m = mask.reshape((1, -1) + (1,) * (leaf.ndim - 2))
            out[name] = torch.where(m, torch.zeros((), dtype=leaf.dtype,
                                                   device=leaf.device), leaf)
    return out


@torch.no_grad()
def superstep(params, cfg, state: Dict[str, Any], n: int, *,
              prompt_chunk: int = 1, layers=None,
              sampled: Optional[bool] = None,
              chunk_rounds: Optional[Sequence[bool]] = None,
              draft=None, draft_params=None):
    """Run ``n`` rounds of the unified serving loop (see the reference's
    ``lm.superstep`` for the full contract).  Per round, for every slot:
    re-admission from staging, token select (next prompt token(s) or the
    fed-back sample), one ``decode_step`` -- or ``decode_chunk`` in a
    chunk round -- the non-finite health guard, sample-or-teacher-force,
    and EOS / length retire.

    Returns ``(tokens (B, n), rids (B, n), state, counters)`` with -1 at
    non-emitting positions, as the reference does.

    Where the reference decides on the device, the caller may say what it
    knows on the host; each flag left None is read from the device, which
    waits for the work queued before it.  ``sampled``: whether any armed
    or staged request samples (if so, the key chain is caught up and the
    noise drawn on the host, after one read of ``key_lag``).
    ``chunk_rounds`` (``prompt_chunk > 1``): per round, whether to run the
    C-token chunk kernel; None reads whether any row is prefilling (the
    reference's ``lax.cond``).  A row prefilling in a round not marked
    takes one prompt token, so a wrong guess costs speed, never tokens:
    the chunk at valid 1 and the step are one kernel, bit for bit.

    ``draft`` (a ``serving.draft`` source; its weights, if any, as
    ``draft_params``) switches to speculative decoding
    (:func:`_superstep_spec`): ``tokens`` / ``rids`` become (B, n,
    draft_len + 1) and the counters gain ``draft_proposed``,
    ``draft_accepted`` and ``emit_rounds``."""
    from repro_torch.serving import sampling

    if prompt_chunk > 1 and not supports_prompt_packing(cfg):
        raise NotImplementedError(
            f"prompt_chunk={prompt_chunk} requires block_kind='minrnn'")
    if draft is not None:
        if not supports_prompt_packing(cfg):
            raise NotImplementedError(
                f"speculative decoding requires a recurrent-state arch "
                f"(block_kind='minrnn'), got block_kind={cfg.block_kind!r}")
        return _superstep_spec(params, cfg, state, n,
                               prompt_chunk=prompt_chunk, draft=draft,
                               draft_params=draft_params, layers=layers,
                               sampled=sampled)
    st = dict(state)
    batch = st["tok"].shape[0]
    p_cap = st["prompt"].shape[1]
    chunk = int(prompt_chunk)
    dev = st["tok"].device
    rows = torch.arange(batch, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    prefill_ct, round_ct, waste_ct, nf_ct = zero, zero, zero, zero
    if layers is None:
        layers = bind_layers(params, cfg)
    if sampled is None:
        sampled = bool(((st["temperature"] > 0)
                        | (st["s_valid"] & (st["s_temperature"] > 0))).any())

    noise = None
    if sampled:
        # a sampled request may emit: bring the key chain up to date and
        # draw the Gumbel noise of the next n chain positions per slot
        st["keys"] = sampling.advance_keys(st["keys"], st["key_lag"].cpu())
        st["key_lag"] = torch.zeros_like(st["key_lag"])
        noise = sampling.gumbel_table(st["keys"], n,
                                      cfg.padded_vocab).to(dev)

    emitted, emit_rids, nonfinite = [], [], []
    for r in range(n):
        # 1. re-admission from the staging buffer
        _arm(st)
        alive = st["alive"]
        waste_ct = waste_ct + (~alive).sum(dtype=torch.int32)
        prefilling = alive & (st["prompt_pos"] < st["prompt_len"])
        round_ct = round_ct + prefilling.sum(dtype=torch.int32)

        if chunk == 1:
            use_chunk = False
        elif chunk_rounds is None:
            use_chunk = bool(prefilling.any())
        else:
            use_chunk = bool(chunk_rounds[r])
        # 2. per-slot token select, 3. the layer stack for all rows
        if use_chunk:
            left = st["prompt_len"] - st["prompt_pos"]
            take = torch.where(prefilling, torch.clamp(left, max=chunk),
                               0).to(torch.int32)
            valid = torch.clamp(take, min=1)      # non-prefilling rows: 1
            idx = st["prompt_pos"][:, None] \
                + torch.arange(chunk, device=dev)[None]
            gathered = torch.gather(st["prompt"], 1,
                                    idx.clamp(0, p_cap - 1).long())
            tok_blk = torch.where(prefilling[:, None], gathered,
                                  st["tok"][:, None])
            logits, st["cache"] = decode_chunk(params, cfg, tok_blk, valid,
                                               st["cache"], layers=layers)
        else:
            take = prefilling.to(torch.int32)
            nxt = st["prompt"][rows, st["prompt_pos"].clamp(0, p_cap - 1)
                               .long()]
            in_tok = torch.where(prefilling, nxt, st["tok"])
            logits, st["cache"] = decode_step(params, cfg, in_tok,
                                              st["cache"], layers=layers)
        prefill_ct = prefill_ct + take.sum(dtype=torch.int32)

        # 3b. numerical health guard: a row whose logits or recurrent
        # state (where the arch carries one) went non-finite dies this
        # round with its emission dropped
        ok = torch.isfinite(logits).all(dim=-1)
        if "h" in st["cache"]:
            h = st["cache"]["h"]
            ok = ok & torch.isfinite(h).transpose(0, 1) \
                .reshape(batch, -1).all(dim=-1)
        bad = alive & ~ok
        nf_ct = nf_ct + (bad & ~prefilling).sum(dtype=torch.int32)

        # 4. sample-or-teacher-force
        gum = None if noise is None else \
            noise[rows, st["key_lag"].clamp(max=n - 1).long()]
        toks = sampling.sample_tokens(logits, gum, st["temperature"],
                                      st["top_k"], st["top_p"])
        pos_next = st["prompt_pos"] + take
        emitting = alive & ~bad & (pos_next >= st["prompt_len"])
        st["key_lag"] = st["key_lag"] + emitting.to(torch.int32)
        emitted.append(torch.where(emitting, toks, -1))
        emit_rids.append(torch.where(emitting, st["rid"], -1))
        nonfinite.append(bad)

        # 5. EOS / length-cap retire (a non-finite row dies too)
        st["remaining"] = st["remaining"] - emitting.to(torch.int32)
        hit_eos = emitting & (st["eos"] >= 0) & (toks == st["eos"])
        died = hit_eos | (emitting & (st["remaining"] <= 0))
        st["alive"] = alive & ~(died | bad)
        st["tok"] = torch.where(emitting, toks, st["tok"])
        st["prompt_pos"] = pos_next

    counters = {"prefill_steps": prefill_ct, "prefill_rounds": round_ct,
                "wasted_slot_steps": waste_ct,
                "nonfinite_decode_rounds": nf_ct,
                "nonfinite": torch.stack(nonfinite, dim=1)}
    return (torch.stack(emitted, dim=1).to(torch.int32),
            torch.stack(emit_rids, dim=1).to(torch.int32), st, counters)


def _arm(st: Dict[str, Any]) -> torch.Tensor:
    """Re-admission: dead rows with a staged request arm it (request
    fields swapped in, prompt position and recurrent state zeroed).
    Updates ``st`` in place; returns the armed-row mask."""
    arm = ~st["alive"] & st["s_valid"]
    for f in _ARM_FIELDS:
        st[f] = torch.where(arm, st["s_" + f], st[f])
    st["prompt"] = torch.where(arm[:, None], st["s_prompt"], st["prompt"])
    st["prompt_pos"] = torch.where(arm, 0, st["prompt_pos"])
    st["alive"] = st["alive"] | arm
    st["s_valid"] = st["s_valid"] & ~arm
    st["cache"] = _reset_slot_rows(st["cache"], arm)
    return arm


def _superstep_spec(params, cfg, state: Dict[str, Any], n: int, *,
                    prompt_chunk: int, draft, draft_params, layers=None,
                    sampled: Optional[bool] = None):
    """The speculative form of :func:`superstep` (the reference's
    ``_superstep_spec``).  Per round, for every slot:

      1. re-admission, also zeroing the drafting history (``n_out``) and
         the source's own per-slot state;
      2. propose: up to S draft tokens per row, kept on decoding rows
         only and capped at ``remaining - 1`` (the round's own token
         covers the rest);
      3. verify: ONE ``decode_verify`` of width W = max(C, S + 1) for the
         whole batch -- decoding rows ``[tok, d_1..d_S]``, prefilling rows
         their next C prompt tokens, dead rows valid 1;
      4. accept: position i's exact token x_i (greedy, or sampled with
         the slot's i-th chained key) against draft d_{i+1}; the row
         commits e = leading matches + 1 tokens, cut after an emitted EOS;
      5. commit: the state gathered at position e - 1 (prefilling rows:
         their take; dead rows: 1), ``pos += e``, the source's ``commit``;
      6. EOS / length retire, as the plain loop.

    Acceptance stays on the device; the host reads nothing per round.
    Sampled rows take their noise from a table of the next
    n (S + 1) chain positions per slot, drawn once, gathered by each
    slot's on-device emission count (``key_lag``)."""
    from repro_torch.serving import sampling

    st = dict(state)
    batch = st["tok"].shape[0]
    p_cap = st["prompt"].shape[1]
    chunk = int(prompt_chunk)
    s_len = int(draft.draft_len)
    n_planes = s_len + 1                        # E: emit planes per round
    width = max(chunk, n_planes)                # W: verify width
    dev = st["tok"].device
    rows = torch.arange(batch, device=dev)
    plane = torch.arange(n_planes, device=dev)[None]
    i32 = torch.int32
    if layers is None:
        layers = bind_layers(params, cfg)
    if sampled is None:
        sampled = bool(((st["temperature"] > 0)
                        | (st["s_valid"] & (st["s_temperature"] > 0))).any())
    noise = None
    if sampled:
        st["keys"] = sampling.advance_keys(st["keys"], st["key_lag"].cpu())
        st["key_lag"] = torch.zeros_like(st["key_lag"])
        noise = sampling.gumbel_table(st["keys"], n * n_planes,
                                      cfg.padded_vocab).to(dev)
    ct = {k: torch.zeros((), dtype=i32, device=dev) for k in (
        "prefill_steps", "prefill_rounds", "wasted_slot_steps",
        "draft_proposed", "draft_accepted", "emit_rounds",
        "nonfinite_decode_rounds")}

    emitted, emit_rids, nonfinite = [], [], []
    for _ in range(n):
        # 1. re-admission
        arm = _arm(st)
        st["n_out"] = torch.where(arm, 0, st["n_out"])
        if "draft_cache" in st:
            st["draft_cache"] = _reset_slot_rows(st["draft_cache"], arm)
        alive = st["alive"]
        ct["wasted_slot_steps"] += (~alive).sum(dtype=i32)
        prefilling = alive & (st["prompt_pos"] < st["prompt_len"])
        decoding = alive & ~prefilling
        ct["prefill_rounds"] += prefilling.sum(dtype=i32)
        left = st["prompt_len"] - st["prompt_pos"]
        take = torch.where(prefilling, torch.clamp(left, max=chunk),
                           0).to(i32)
        ct["prefill_steps"] += take.sum(dtype=i32)

        # 2. proposal, decoding rows only, within the length budget
        drafts, n_draft = draft.propose(draft_params, st)
        n_draft = torch.where(
            decoding, torch.clamp(torch.minimum(n_draft, st["remaining"] - 1),
                                  0, s_len), 0).to(i32)
        ct["draft_proposed"] += n_draft.sum(dtype=i32)

        # 3. one verify pass for the whole batch
        idx = st["prompt_pos"][:, None] \
            + torch.arange(width, device=dev)[None]
        gathered = torch.gather(st["prompt"], 1,
                                idx.clamp(0, p_cap - 1).long())
        dec_blk = torch.cat([st["tok"][:, None], drafts.to(i32)], dim=1)
        if width > n_planes:
            dec_blk = torch.cat([dec_blk, dec_blk.new_zeros(
                (batch, width - n_planes))], dim=1)
        tok_blk = torch.where(prefilling[:, None], gathered, dec_blk)
        valid_in = torch.where(prefilling, torch.clamp(take, min=1),
                               1 + n_draft).to(i32)
        logits_all, pstates = decode_verify(params, cfg, tok_blk, valid_in,
                                            st["cache"], layers=layers)

        # 3b. health guard over the logits and every per-position state
        ok = torch.isfinite(logits_all).flatten(1).all(dim=1)
        ok = ok & torch.isfinite(pstates["h"]).transpose(0, 1) \
            .reshape(batch, -1).all(dim=1)
        bad = alive & ~ok
        ct["nonfinite_decode_rounds"] += (bad & ~prefilling).sum(dtype=i32)

        # 4a. the exact token at every position under the chained keys;
        # a prefilling row emits at most its first token, from the logits
        # at its last prompt position with the slot's current key
        gum = None
        if noise is not None:
            gidx = (st["key_lag"][:, None] + plane).clamp(
                max=n * n_planes - 1).long()
            gum = noise[rows[:, None], gidx]            # (B, E, V)
        x_toks = sampling.chain_tokens(
            logits_all[:, :n_planes], gum, st["temperature"], st["top_k"],
            st["top_p"])
        last_logits = logits_all[rows, (valid_in - 1).long()]
        tok_first = sampling.sample_tokens(
            last_logits, None if gum is None else gum[:, 0],
            st["temperature"], st["top_k"], st["top_p"])

        # 4b. acceptance: the leading run of matching drafts + 1, cut
        # after the first emitted EOS
        m = (x_toks[:, :s_len] == tok_blk[:, 1:n_planes]) \
            & (plane[:, :s_len] < n_draft[:, None])
        lead = torch.cumprod(m.to(i32), dim=1).sum(dim=1, dtype=i32)
        is_eos = (st["eos"] >= 0)[:, None] & (x_toks == st["eos"][:, None])
        first_eos = torch.where(is_eos, plane, n_planes).amin(dim=1)
        e = torch.minimum(lead + 1, first_eos + 1).to(i32)
        ct["draft_accepted"] += torch.where(decoding & ~bad, e - 1,
                                            0).sum(dtype=i32)
        pos_next = st["prompt_pos"] + take
        pf_emit = prefilling & (pos_next >= st["prompt_len"])
        emitting = (pf_emit | decoding) & ~bad
        ct["emit_rounds"] += emitting.sum(dtype=i32)
        n_emit = torch.where(bad, 0, torch.where(decoding, e,
                                                 pf_emit.to(i32))).to(i32)

        # 4c. the emit planes: -1 past each row's committed length
        emit_tok = torch.where(decoding[:, None], x_toks, tok_first[:, None])
        live_plane = plane < n_emit[:, None]
        emit = torch.where(live_plane, emit_tok, -1)
        emitted.append(emit)
        emit_rids.append(torch.where(live_plane, st["rid"][:, None], -1))
        nonfinite.append(bad)

        # the key chain advances one split per emitted token; tok becomes
        # the last one
        st["key_lag"] = st["key_lag"] + n_emit
        kidx = torch.clamp(n_emit - 1, 0, n_planes - 1).long()
        last_tok = emit_tok[rows, kidx]
        st["tok"] = torch.where(emitting, last_tok, st["tok"])

        # drafting history: the emitted tokens appended to the prompt
        # buffer; writes past its end (only a request's final token)
        # land in a scratch column and are dropped
        hist = st["prompt_len"] + st["n_out"]
        w_idx = torch.where(live_plane, hist[:, None] + plane, p_cap) \
            .clamp(max=p_cap).long()
        buf = torch.cat([st["prompt"], st["prompt"].new_zeros((batch, 1))],
                        dim=1)
        buf.scatter_(1, w_idx, torch.clamp(emit, min=0).to(buf.dtype))
        st["prompt"] = buf[:, :p_cap]
        st["n_out"] = st["n_out"] + n_emit

        # 5. commit: each row's state at its last committed position
        valid_eff = torch.where(prefilling, torch.clamp(take, min=1),
                                torch.where(decoding, e, 1)).to(i32)
        g_idx = (valid_eff - 1).long()
        new_cache = dict(st["cache"])
        for k, v in pstates.items():
            new_cache[k] = v[:, rows, g_idx].contiguous()
        new_cache["pos"] = st["cache"]["pos"] + valid_eff
        st["cache"] = new_cache
        st.update(draft.commit(draft_params, st, tok_blk, valid_eff))

        # 6. EOS / length retire (an emitted EOS is the last plane)
        st["remaining"] = st["remaining"] - n_emit
        hit_eos = emitting & (st["eos"] >= 0) & (last_tok == st["eos"])
        died = hit_eos | (emitting & (st["remaining"] <= 0))
        st["alive"] = alive & ~(died | bad)
        st["prompt_pos"] = pos_next

    ct["nonfinite"] = torch.stack(nonfinite, dim=1)
    return (torch.stack(emitted, dim=1).to(i32),
            torch.stack(emit_rids, dim=1).to(i32), st, ct)
