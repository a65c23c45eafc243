"""Port parity for gemma-2b-mingru, gemma-2b's trunk with the paper's
minGRU as its sequence mixer, served through the cell-fused tier (its
training trajectory is in ``test_torch_gemma.py``).

The smoke config (2 layers, d64, vocab 1024, fp32) is built in both
packages, the JAX params bridged into the port, and the same tokens go
through both.  The JAX side runs its ``decode_step`` Pallas kernel in
interpret mode, the port the kernel's plain version (CPU tensors).
Tolerance: fp32 at atol = rtol = 1e-5 (the same arithmetic, matmuls
summed in another order).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.models import lm as jax_lm
from repro.serving import engine as jax_engine
from repro_torch import bridge, tree
from repro_torch.configs import archs as pt_archs
from repro_torch.models import lm as pt_lm
from repro_torch.serving import engine as pt_engine

ARCH = "gemma-2b-mingru"
TOL = 1e-5
MAX_LEN = 32
PROMPTS = ([5, 17, 900, 3], [9], [1000, 1, 2, 3, 4, 5], [42, 42])
MAX_NEW = (5, 4, 3, 6)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jax_archs.smoke(ARCH)
    pcfg = pt_archs.smoke(ARCH)
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    refs = tuple(tuple(jax_engine.generate_one(jcfg, jparams, p, max_new=m,
                                               max_len=MAX_LEN))
                 for p, m in zip(PROMPTS, MAX_NEW))
    return jcfg, pcfg, jparams, pparams, refs


def _close(want, got):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("get", ["get", "smoke"])
def test_config_equals_reference(get):
    j = getattr(jax_archs, get)(ARCH)
    p = getattr(pt_archs, get)(ARCH)
    for f in ("block_kind", "seq_mixer", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab_size", "norm",
              "norm_zero_centered", "mlp_activation", "gated_mlp",
              "mlp_bias", "rope", "rope_theta", "attn_kind",
              "tie_embeddings", "embedding_scale", "param_dtype",
              "compute_dtype", "scan_strategy", "fuse_block", "remat",
              "padded_vocab"):
        assert getattr(j, f) == getattr(p, f), (get, f)
    for f in ("cell", "expansion", "mode", "use_conv", "conv_kernel",
              "use_mlp"):
        assert getattr(j.minrnn, f) == getattr(p.minrnn, f), (get, f)


def test_bridged_params_carry_the_attention_trunk():
    _, pcfg, jparams, pparams, _ = _setup()
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == len(tree.leaves(pparams))
    paths = set()
    for path, leaf in flat:
        t = pparams
        for k in path:
            t = t[k.key]
        paths.add(".".join(k.key for k in path))
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    for leaf in ("norm1.scale", "mixer.rnn.wz.kernel", "mixer.rnn.wh.bias",
                 "mixer.down.kernel", "norm2.scale", "mlp.up.kernel",
                 "mlp.gate.kernel", "mlp.down.kernel"):
        assert f"layers.blocks.{leaf}" in paths, leaf
    # the port's own init has the same tree, shapes and dtypes
    own = pt_lm.init_params(torch.Generator().manual_seed(0), pcfg,
                            device="cpu")
    got = {".".join(p): (tuple(a.shape), a.dtype)
           for p, a in _paths(own)}
    want = {".".join(p): (tuple(a.shape), a.dtype) for p, a in _paths(pparams)}
    assert got == want


def _paths(t, prefix=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, t


def test_decode_step_logits_match_jax():
    jcfg, pcfg, jparams, pparams, _ = _setup()
    assert pt_lm.kernel_tier(pcfg) == "cell-fused"
    rng = np.random.default_rng(0)
    jc = jax_lm.init_cache(jcfg, 3, 16)
    pc = pt_lm.init_cache(pcfg, 3, 16, device="cpu")
    assert set(pc) == set(jc) == {"pos", "h"}
    step = jax.jit(lambda p, t, c: jax_lm.decode_step(p, jcfg, t, c))
    for _ in range(4):
        t = rng.integers(0, 1024, size=(3,)).astype(np.int32)
        jl, jc = step(jparams, jnp.asarray(t), jc)
        pl, pc = pt_lm.decode_step(pparams, pcfg, torch.from_numpy(t), pc)
        _close(jl, pl)
    _close(jc["h"], pc["h"])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), pc["pos"].numpy())


def _serve(pcfg, pparams, k, **submit_kw):
    eng = pt_engine.ServingEngine(pcfg, pparams, max_batch=2,
                                  max_len=MAX_LEN, decode_block=k, seed=7,
                                  device="cpu")
    rids = [eng.submit(p, max_new=m, **submit_kw)
            for p, m in zip(PROMPTS, MAX_NEW)]
    outs = eng.run_to_completion()
    assert eng.stats.shard_identities_ok()
    assert eng.kernel_tier == "cell-fused"
    return [tuple(outs[r]) for r in rids]


@pytest.mark.parametrize("k", [1, 4])
def test_engine_greedy_streams_equal_jax_generate_one(k):
    _, pcfg, _, pparams, refs = _setup()
    assert tuple(_serve(pcfg, pparams, k)) == refs


def test_sampled_streams_equal_jax_engine():
    jcfg, pcfg, jparams, pparams, _ = _setup()
    kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    jeng = jax_engine.ServingEngine(jcfg, jparams, max_batch=2,
                                    max_len=MAX_LEN, decode_block=2, seed=7)
    jr = [jeng.submit(p, max_new=m, **kw) for p, m in zip(PROMPTS, MAX_NEW)]
    jouts = jeng.run_to_completion()
    assert _serve(pcfg, pparams, 2, **kw) == [tuple(jouts[r]) for r in jr]


def test_prompt_packing_and_training_are_refused():
    """Prompt packing stays refused on the attention trunk, as in the
    reference; training is no longer refused: ``forward`` and ``loss_fn``
    match the JAX package's."""
    jcfg, pcfg, jparams, pparams, _ = _setup()
    with pytest.raises(ValueError, match="prompt_chunk"):
        pt_engine.ServingEngine(pcfg, pparams, max_batch=2, max_len=MAX_LEN,
                                prompt_chunk=4, device="cpu")
    state = pt_lm.init_slot_state(pcfg, 2, MAX_LEN, device="cpu")
    with pytest.raises(NotImplementedError, match="prompt_chunk"):
        pt_lm.superstep(pparams, pcfg, state, 2, prompt_chunk=4)
    toks = np.random.default_rng(3).integers(0, 1024, (2, 9)).astype(
        np.int32)
    want, _ = jax_lm.forward(jparams, jcfg, jnp.asarray(toks))
    got, _ = pt_lm.forward(pparams, pcfg, torch.from_numpy(toks))
    _close(want, got)
    labels = np.where(toks % 5 == 0, -1, toks)
    batch = {"tokens": toks, "labels": labels}
    jl, _ = jax_lm.loss_fn(jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    pl, _ = pt_lm.loss_fn(pparams, pcfg, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL)


def test_native_mla_builds_on_the_gemma_trunk():
    """Native GQA is tested in ``test_torch_gemma.py``; with MLA in place
    of the minGRU mixer the trunk builds, its cache is MLA's latent one,
    and a decode step gives the reference's logits and cache."""
    over = dict(seq_mixer="native", attn_kind="mla", mla_q_lora=32,
                mla_kv_lora=16, mla_rope_dim=8, mla_qk_nope_dim=16,
                mla_v_dim=16)
    jcfg = jax_archs.smoke(ARCH).replace(**over)
    cfg = pt_archs.smoke(ARCH).replace(**over)
    own = pt_lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    assert tuple(own["layers"]["blocks"]["mixer"]["wkv_a"]["kernel"].shape
                 ) == (2, 64, 24)
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    jc = jax_lm.init_cache(jcfg, 2, 8)
    pc = pt_lm.init_cache(cfg, 2, 8, device="cpu")
    assert {k: tuple(v.shape) for k, v in pc.items()} == \
        {k: v.shape for k, v in jc.items()} == \
        {"pos": (2,), "ckv": (2, 2, 8, 16), "krope": (2, 2, 8, 8)}
    tok = np.array([5, 900], np.int32)
    jl, jc = jax_lm.decode_step(jparams, jcfg, jnp.asarray(tok), jc)
    pl, pc = pt_lm.decode_step(pparams, cfg, torch.from_numpy(tok), pc)
    _close(jl, pl)
    _close(jc["ckv"], pc["ckv"])
