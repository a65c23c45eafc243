"""Port parity for the parallel prefill: ``nn.gather_conv_window``,
``blocks.apply``'s prefill branches (``return_state``, ``lengths``,
``state0``) and ``lm.prefill`` (fresh and resumed, padded and not).

The same seeded numpy inputs and the same weights (bridged from the JAX
init) go through both packages.  The JAX side runs its fused Pallas
kernels in interpret mode, the port the kernels' plain versions (CPU
tensors).  Tolerance: fp32 at atol = rtol = 3e-5 (the same arithmetic,
sums in another order).  Padded against unpadded prefill is held to that
tolerance too, not bit for bit: the reference's own ``exact=True`` cases
are red.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.core import blocks as jax_blocks
from repro.core import nn as jax_nn
from repro.models import lm as jax_lm
from repro.serving import engine as jax_engine
from repro_torch import bridge
from repro_torch.configs import archs as pt_archs
from repro_torch.core import blocks as pt_blocks
from repro_torch.core import nn as pt_nn
from repro_torch.models import lm as pt_lm
from repro_torch.serving import engine as pt_engine

TOL = 3e-5
MAX_LEN = 64
ARCHS = ("mingru-lm", "minlstm-lm", "gemma-2b-mingru")
# right-padded to T 9
LENGTHS = (9, 1, 4, 7)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = jax_archs.smoke(arch)
    pcfg = pt_archs.smoke(arch)
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, pcfg, jparams, pparams


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _tokens(cfg, seed, bsz=len(LENGTHS), t=max(LENGTHS)):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, size=(bsz, t)).astype(np.int32)


def _cache_close(jcache, pcache):
    assert set(jcache) == set(pcache)
    for k in jcache:
        if k == "pos":
            np.testing.assert_array_equal(pcache[k].numpy(),
                                          np.asarray(jcache[k]))
        else:
            _close(jcache[k], pcache[k])


# ---------------------------------------------------------------------------
# nn.gather_conv_window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_prefix", [False, True])
def test_gather_conv_window_bit_equal_to_jax(with_prefix):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 7, 5)).astype(np.float32)
    prefix = rng.standard_normal((4, 3, 5)).astype(np.float32) \
        if with_prefix else None
    lengths = np.array([7, 1, 2, 5], np.int32)
    want = jax_nn.gather_conv_window(
        jnp.asarray(x), jnp.asarray(lengths), 3,
        prefix=None if prefix is None else jnp.asarray(prefix))
    got = pt_nn.gather_conv_window(
        torch.from_numpy(x), torch.from_numpy(lengths), 3,
        prefix=None if prefix is None else torch.from_numpy(prefix))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# blocks.apply's prefill branches
# ---------------------------------------------------------------------------

def _block_pair(cell):
    kw = dict(d_model=32, cell=cell, expansion=2.0, use_conv=True,
              use_mlp=True, mode="log")
    jc = jax_blocks.MinRNNBlockConfig(**kw)
    pc = pt_blocks.MinRNNBlockConfig(**kw)
    jp = jax_blocks.init(jax.random.PRNGKey(3), jc)
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, pc, jp, pp


@pytest.mark.parametrize("cell", ["mingru", "minlstm"])
@pytest.mark.parametrize("branch", ["return_state", "lengths", "state0",
                                    "state0_lengths", "short"])
def test_block_apply_prefill_branches_match_jax(cell, branch):
    jc, pc, jp, pp = _block_pair(cell)
    rng = np.random.default_rng(1)
    t = 2 if branch == "short" else 6       # "short": T < the conv width
    x = rng.standard_normal((3, t, 32)).astype(np.float32)
    kw_j, kw_p = {}, {}
    if branch in ("lengths", "state0_lengths"):
        lens = np.array([6, 2, 4], np.int32)
        kw_j["lengths"], kw_p["lengths"] = jnp.asarray(lens), \
            torch.from_numpy(lens)
    if branch.startswith("state0"):
        h = np.abs(rng.standard_normal((3, 64))).astype(np.float32)
        conv = rng.standard_normal((3, 3, 32)).astype(np.float32)
        kw_j["state0"] = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        kw_p["state0"] = {"h": torch.from_numpy(h),
                          "conv": torch.from_numpy(conv)}
    y_j, st_j = jax_blocks.apply(jp, jc, jnp.asarray(x), return_state=True,
                                 **kw_j)
    y_p, st_p = pt_blocks.apply(pp, pc, torch.from_numpy(x),
                                return_state=True, **kw_p)
    _close(y_j, y_p)
    assert set(st_j) == set(st_p) == {"h", "conv"}
    for k in st_j:
        _close(st_j[k], st_p[k])


# ---------------------------------------------------------------------------
# lm.prefill against the JAX prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("padded", [False, True])
def test_prefill_logits_and_cache_match_jax(arch, padded):
    jcfg, pcfg, jparams, pparams = _pair(arch)
    toks = _tokens(jcfg, 2)
    lens = np.array(LENGTHS, np.int32) if padded else None
    lj, cj = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), MAX_LEN,
                            lengths=None if lens is None
                            else jnp.asarray(lens))
    lp, cp = pt_lm.prefill(pparams, pcfg, torch.from_numpy(toks), MAX_LEN,
                           lengths=None if lens is None
                           else torch.from_numpy(lens))
    _close(lj, lp)
    _cache_close(cj, cp)


@pytest.mark.parametrize("arch", ["mingru-lm", "minlstm-lm"])
def test_resumed_prefill_matches_jax_and_single_pass(arch):
    """A prompt split at 5 tokens, the second part resumed from the first
    part's cache, against the JAX resumed prefill and the port's single
    pass."""
    jcfg, pcfg, jparams, pparams = _pair(arch)
    toks = _tokens(jcfg, 4)
    lj, cj = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks[:, :5]), MAX_LEN)
    lj, cj = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks[:, 5:]), MAX_LEN,
                            cache=cj)
    tp = torch.from_numpy(toks)
    lp, cp = pt_lm.prefill(pparams, pcfg, tp[:, :5], MAX_LEN)
    lp, cp = pt_lm.prefill(pparams, pcfg, tp[:, 5:], MAX_LEN, cache=cp)
    _close(lj, lp)
    _cache_close(cj, cp)
    l1, c1 = pt_lm.prefill(pparams, pcfg, tp, MAX_LEN)
    _close(l1.numpy(), lp)
    for k in c1:
        _close(c1[k].numpy(), cp[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prefill_matches_per_row(arch):
    """Each row of a right-padded batch against its own unpadded
    prefill, to tolerance."""
    _, pcfg, _, pparams = _pair(arch)
    toks = torch.from_numpy(_tokens(pcfg, 5))
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    lp, cp = pt_lm.prefill(pparams, pcfg, toks, MAX_LEN, lengths=lens)
    for b, n in enumerate(LENGTHS):
        l1, c1 = pt_lm.prefill(pparams, pcfg, toks[b:b + 1, :n], MAX_LEN)
        _close(l1[0].numpy(), lp[b])
        for k in c1:
            if k == "pos":
                assert int(cp[k][b]) == n
            else:
                _close(c1[k][:, 0].numpy(), cp[k][:, b])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_generate_one(arch):
    """Greedy streams of prefill + decode_step equal ``generate_one``'s,
    the port's and the JAX package's (the reference's
    test_generate_one_matches_parallel_prefill)."""
    jcfg, pcfg, jparams, pparams = _pair(arch)
    for prompt in ([1, 2, 3, 4], [7, 5, 3], [2] * 9):
        seq = pt_engine.generate_one(pcfg, pparams, prompt, max_new=6,
                                     max_len=MAX_LEN, device="cpu")
        logits, cache = pt_lm.prefill(
            pparams, pcfg, torch.tensor([prompt], dtype=torch.int32),
            MAX_LEN)
        par = [int(logits[0, :pcfg.vocab_size].argmax())]
        for _ in range(5):
            logits, cache = pt_lm.decode_step(
                pparams, pcfg, torch.tensor([par[-1]], dtype=torch.int32),
                cache)
            par.append(int(logits[0, :pcfg.vocab_size].argmax()))
        assert seq == par, (prompt, seq, par)
        assert par == jax_engine.generate_one(jcfg, jparams, prompt,
                                              max_new=6, max_len=MAX_LEN)


def test_prefill_cache_resume_raises_on_attention_trunk():
    _, pcfg, _, pparams = _pair("gemma-2b-mingru")
    toks = torch.ones((1, 3), dtype=torch.int32)
    _, cache = pt_lm.prefill(pparams, pcfg, toks, MAX_LEN)
    assert not pt_lm.supports_chunked_prefill(pcfg)
    with pytest.raises(NotImplementedError, match="resume"):
        pt_lm.prefill(pparams, pcfg, toks, MAX_LEN, cache=cache)


def test_prefill_of_the_mla_trunk_matches_jax():
    """gemma-2b's trunk with MLA in place of GQA: a right-padded prefill
    (``LENGTHS``) seeds MLA's latent cache as the reference's does."""
    over = dict(attn_kind="mla", mla_q_lora=32, mla_kv_lora=16,
                mla_rope_dim=8, mla_qk_nope_dim=16, mla_v_dim=16)
    jcfg = jax_archs.smoke("gemma-2b").replace(**over)
    pcfg = pt_archs.smoke("gemma-2b").replace(**over)
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    toks = _tokens(pcfg, 6)
    lengths = np.asarray(LENGTHS, np.int32)
    jl, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), 16,
                            lengths=jnp.asarray(lengths))
    pl, pc = pt_lm.prefill(pparams, pcfg, torch.from_numpy(toks), 16,
                           lengths=torch.from_numpy(lengths))
    assert set(pc) == {"pos", "ckv", "krope"}
    _close(jl, pl)
    _cache_close(jc, pc)
