"""Task heads over the minRNN blocks (``repro.models.heads``): sequence
classification (the Chomsky-hierarchy suite and the ListOps ablation,
the paper's Tables 4-6) and the Decision-Transformer-style offline-RL
model (Table 3: minRNN -> MLP in place of self-attention in the DT
frame).

Both run their stacked ``blocks`` params through ``blocks.apply`` one
layer at a time, under the block config's strategy: with the default
``"auto"`` each layer's forward is one launch of the fused CUDA cell
kernel (``fused_mingru_kernel`` / ``fused_minlstm_kernel``) and its
backward one reversed ``linear_scan_kernel``; ``"pallas"`` takes the
CUDA scans instead.  On CPU tensors the kernels' plain versions run.
Params keep the reference's pytree layout, so ``bridge.params_from_jax``
carries its weights across leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import blocks as minrnn_blocks
from repro_torch.core import nn
from repro_torch.device import resolve_device
from repro_torch.tree import leaves, stack, tree_map


def _stack_blocks(gen, n_layers: int, block_cfg, dtype) -> dict:
    """``n_layers`` block inits stacked on a leading axis."""
    return stack([minrnn_blocks.init(gen, block_cfg, dtype=dtype)
                  for _ in range(n_layers)])


def _to(tree, device):
    dev = resolve_device(device)
    return tree_map(lambda a: a.to(dev), tree)


def _trunk(params, block_cfg, x: torch.Tensor) -> torch.Tensor:
    """The stacked blocks, one layer at a time, then the final norm."""
    blocks = params["blocks"]
    for i in range(leaves(blocks)[0].shape[0]):
        x = minrnn_blocks.apply(tree_map(lambda a: a[i], blocks), block_cfg,
                                x)
    return nn.norm_apply(block_cfg.norm, params["final_norm"], x)


# ---------------------------------------------------------------------------
# Sequence classifier: embed -> [blocks] -> last-position head
# ---------------------------------------------------------------------------

def classifier_init(gen: torch.Generator, *, vocab: int, n_classes: int,
                    d_model: int, n_layers: int,
                    block_cfg: minrnn_blocks.MinRNNBlockConfig,
                    dtype=torch.float32, device="cuda"):
    """Seeded init in the reference's layout, drawn on ``gen``'s device,
    then moved to ``device``."""
    return _to({
        "embed": {"table": nn.normal_init(gen, (vocab, d_model), 0.02,
                                          dtype)},
        "blocks": _stack_blocks(gen, n_layers, block_cfg, dtype),
        "final_norm": nn.norm_init(block_cfg.norm, d_model, dtype),
        "head": nn.dense_init(gen, d_model, n_classes, dtype=dtype),
    }, device)


def classifier_apply(params, block_cfg, tokens: torch.Tensor, *,
                     lengths=None) -> torch.Tensor:
    """tokens: (B, T) -> logits (B, n_classes), pooled at ``lengths - 1``
    (each row's last real position) or at T - 1."""
    x = _trunk(params, block_cfg, params["embed"]["table"][tokens.long()])
    if lengths is None:
        pooled = x[:, -1]
    else:
        idx = torch.clamp(lengths.long() - 1, min=0)
        pooled = x[torch.arange(x.shape[0], device=x.device), idx]
    return nn.dense_apply(params["head"], pooled)


def classifier_loss(params, block_cfg, batch) -> Tuple[torch.Tensor, Dict]:
    """batch: tokens (B, T), label (B,)[, lengths (B,)] -> (mean NLL in
    fp32, {"loss", "acc"} detached)."""
    logits = classifier_apply(params, block_cfg, batch["tokens"],
                              lengths=batch.get("lengths"))
    labels = batch["label"].long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    acc = (logits.argmax(-1) == labels).float().mean()
    loss = nll.mean()
    return loss, {"loss": loss.detach(), "acc": acc}


# ---------------------------------------------------------------------------
# Decision-Transformer-style trajectory model (paper App. C.2: minRNN ->
# MLP): interleaves (rtg_t, s_t, a_t) tokens, predicts a_t from s_t's
# position
# ---------------------------------------------------------------------------

def dt_init(gen: torch.Generator, *, state_dim: int, act_dim: int,
            d_model: int, n_layers: int,
            block_cfg: minrnn_blocks.MinRNNBlockConfig,
            dtype=torch.float32, device="cuda"):
    return _to({
        "embed_s": nn.dense_init(gen, state_dim, d_model, dtype=dtype),
        "embed_a": nn.dense_init(gen, act_dim, d_model, dtype=dtype),
        "embed_r": nn.dense_init(gen, 1, d_model, dtype=dtype),
        "blocks": _stack_blocks(gen, n_layers, block_cfg, dtype),
        "final_norm": nn.norm_init(block_cfg.norm, d_model, dtype),
        "head": nn.dense_init(gen, d_model, act_dim, dtype=dtype),
    }, device)


def dt_apply(params, block_cfg, states: torch.Tensor, actions: torch.Tensor,
             rtg: torch.Tensor) -> torch.Tensor:
    """states (B, H, S), actions (B, H, A), rtg (B, H, 1) -> predicted
    actions (B, H, A) from each state position (causal: a_t sees
    R_{<=t}, s_{<=t}, a_{<t})."""
    b, h, _ = states.shape
    es = nn.dense_apply(params["embed_s"], states)
    ea = nn.dense_apply(params["embed_a"], actions)
    er = nn.dense_apply(params["embed_r"], rtg)
    # interleave (r_t, s_t, a_t): (B, 3H, D)
    x = torch.stack([er, es, ea], dim=2).reshape(b, 3 * h, es.shape[-1])
    x = _trunk(params, block_cfg, x)
    return torch.tanh(nn.dense_apply(params["head"], x[:, 1::3]))


def dt_loss(params, block_cfg, batch) -> Tuple[torch.Tensor, Dict]:
    pred = dt_apply(params, block_cfg, batch["states"], batch["actions"],
                    batch["rtg"])
    mse = torch.mean((pred - batch["actions"]) ** 2)
    return mse, {"loss": mse.detach()}
