"""Port parity for the encoder-decoder (``models/encdec.py``):
whisper-base (smoke: 2 encoder and 2 decoder layers, d64, 4 heads of
16, LayerNorm, biased attention and a plain GELU MLP, learned
positions, 16 stub frames of dim 32, vocab 512, tied output, fp32),
encoded, trained, prefilled and decoded.

The JAX params are bridged into the port and the same numpy-seeded
inputs go through both packages.  Encoder outputs, logits, caches and
losses at atol = rtol = 1e-5 (the same arithmetic, sums in another
order); gradients and the 5-step trajectory at the tolerances of
``test_torch_training.py`` (grads rtol 1e-4 / atol 1e-5; per-step
metrics rtol 1e-4; final params rtol 1e-3 / atol 1e-4).  The decode
loop must match teacher-forced ``forward`` at 1e-5, and a decode row
stepped in a batch of 8 must equal the row stepped alone bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.data import lm_corpus as jax_corpus
from repro.models import encdec as jax_encdec
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro_torch import bridge, tree
from repro_torch.configs import archs as pt_archs
from repro_torch.models import encdec as pt_encdec
from repro_torch.models import lm as pt_lm
from repro_torch.training import optimizer as pt_opt
from repro_torch.training import train_step as pt_ts

ARCH = "whisper-base"
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup(**over):
    jcfg = jax_archs.smoke(ARCH).replace(**over)
    pcfg = pt_archs.smoke(ARCH).replace(**over)
    jparams = jax_encdec.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, pcfg, jparams, pparams


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _flat(t, path=()):
    if isinstance(t, dict):
        for k in t:
            yield from _flat(t[k], path + (k,))
    else:
        yield path, t


def _trees_close(jtree, ptree, rtol, atol):
    jflat = dict(_flat(jax.tree.map(np.asarray, jtree)))
    pflat = dict(_flat(ptree))
    assert set(jflat) == set(pflat)
    for k, v in jflat.items():
        np.testing.assert_allclose(pflat[k].detach().float().numpy(),
                                   np.asarray(v, np.float32), rtol=rtol,
                                   atol=atol, err_msg=str(k))


def _frames(seed, bsz=2, t=16, dim=32):
    return np.random.default_rng(seed).standard_normal(
        (bsz, t, dim)).astype(np.float32)


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


_CORPUS = {}


def _batch(step, batch=2, seq=16):
    if "train" not in _CORPUS:
        _CORPUS["train"] = jax_corpus.build_corpus(target_bytes=20_000)[0]
    out = dict(jax_corpus.lm_batch(_CORPUS["train"], 0, step, batch, seq))
    out["frames"] = _frames(100 + step, batch)
    return out


# ---------------------------------------------------------------------------
# Config and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("get", ["get", "smoke"])
def test_config_equals_reference(get):
    j = getattr(jax_archs, get)(ARCH)
    p = getattr(pt_archs, get)(ARCH)
    for f in dataclasses.fields(p):
        assert getattr(j, f.name) == getattr(p, f.name), (get, f.name)
    assert (j.head_dim_, j.padded_vocab) == (p.head_dim_, p.padded_vocab)
    assert p.family == "encdec" and pt_ts.model_for(p) is pt_encdec
    assert pt_ts.model_for(pt_archs.smoke("starcoder2-15b")) is pt_lm


def test_bridged_params_and_own_init_share_the_tree():
    _, pcfg, jparams, pparams = _setup()
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == len(tree.leaves(pparams))
    paths = {".".join(k.key for k in path) for path, _ in flat}
    for leaf in ("frame_proj.kernel", "frame_proj.bias", "enc_pos.table",
                 "dec_pos.table", "embed.table", "enc_norm.bias",
                 "final_norm.scale", "encoder.attn.wq.bias",
                 "decoder.self_attn.wo.bias", "decoder.norm_x.scale",
                 "decoder.cross_attn.wk.kernel", "decoder.mlp.up.bias"):
        assert leaf in paths, leaf
    own = pt_encdec.init_params(torch.Generator().manual_seed(0), pcfg,
                                device="cpu")
    got = {p: (tuple(a.shape), a.dtype) for p, a in tree.leaves_with_path(own)}
    want = {p: (tuple(a.shape), a.dtype)
            for p, a in tree.leaves_with_path(pparams)}
    assert got == want


def test_the_lm_refuses_the_encoder_decoder_and_back():
    cfg = pt_archs.smoke(ARCH)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="models/encdec.py"):
        pt_lm.init_params(gen, cfg, device="cpu")
    with pytest.raises(ValueError, match="models/encdec.py"):
        pt_lm.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="models/lm.py"):
        pt_encdec.init_params(gen, pt_archs.smoke("starcoder2-15b"),
                              device="cpu")


# ---------------------------------------------------------------------------
# Encoder, teacher-forced decoder, loss, gradients
# ---------------------------------------------------------------------------

def test_encode_matches_jax():
    jcfg, pcfg, jparams, pparams = _setup()
    fr = _frames(1)
    want = jax_encdec.encode(jparams, jcfg, jnp.asarray(fr))
    got = pt_encdec.encode(pparams, pcfg, torch.from_numpy(fr))
    assert tuple(got.shape) == (2, 16, pcfg.d_model)
    _close(want, got)


@pytest.mark.parametrize("tile", [1024, 4])
def test_forward_logits_match_jax(tile):
    """Whole tiles and 4-wide ones (the encoder's non-causal and the
    cross-attention's kv tiles, the decoder's causal ones)."""
    jcfg, pcfg, jparams, pparams = _setup(attn_q_chunk=tile,
                                          attn_kv_chunk=tile)
    fr, toks = _frames(2), _tokens(3, (2, 11))
    want = jax_encdec.forward(jparams, jcfg, jnp.asarray(fr),
                              jnp.asarray(toks))
    got = pt_encdec.forward(pparams, pcfg, torch.from_numpy(fr),
                            torch.from_numpy(toks))
    assert tuple(got.shape) == (2, 11, pcfg.padded_vocab)
    _close(want, got)


def test_loss_and_grads_match_jax():
    jcfg, pcfg, jparams, pparams = _setup()
    batch = _batch(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_encdec.loss_fn(p, jcfg, b), has_aux=True))(
        jparams, batch)
    (pl, pm), pg = pt_ts.value_and_grad(pt_ts.make_loss_fn(pcfg), pparams,
                                        pt_ts.batch_to(batch, "cpu"))
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL)
    assert set(pm) == set(jm)
    assert float(pm["ntokens"]) == float(jm["ntokens"])
    _trees_close(jg, pg, rtol=1e-4, atol=1e-5)
    for leaf in tree.leaves(pparams):
        leaf.requires_grad_(False)


def test_remat_full_matches_no_remat():
    _, pcfg, _, pparams = _setup()
    batch = pt_ts.batch_to(_batch(1), "cpu")
    outs = []
    for remat in ("none", "full", "dots"):
        cfg = pcfg.replace(remat=remat)
        outs.append(pt_ts.value_and_grad(pt_ts.make_loss_fn(cfg), pparams,
                                         batch))
    (l0, _), g0 = outs[0]
    for (l1, _), g1 in outs[1:]:
        assert float(l0) == float(l1)
        for (k, a), (_, b) in zip(_flat(g0), _flat(g1)):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(k))
    for leaf in tree.leaves(pparams):
        leaf.requires_grad_(False)


def test_five_step_trajectory_matches_jax():
    """Both train steps pick the model through ``model_for``."""
    jcfg, pcfg, jparams, pparams = _setup()
    jparams = jax.tree.map(jnp.array, jparams)           # the step donates
    pparams = tree.tree_map(torch.clone, pparams)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    jstep = jax.jit(jax_ts.make_train_step(jcfg,
                                           jax_opt.AdamWConfig(**ocfg)))
    pstep = pt_ts.make_train_step(pcfg, pt_opt.AdamWConfig(**ocfg))
    jstate = jax_opt.init(jax_opt.AdamWConfig(**ocfg), jparams)
    pstate = pt_opt.init(pt_opt.AdamWConfig(**ocfg), pparams)
    losses = []
    for step in range(5):
        batch = _batch(step)
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        pparams, pstate, pm = pstep(pparams, pstate, batch)
        for k in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} @ {step}")
        losses.append(float(pm["loss"]))
    assert losses[-1] < losses[0]
    _trees_close(jparams, pparams, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# Prefill (encode, cross k / v once) and decode
# ---------------------------------------------------------------------------

def test_init_cache_matches_jax():
    jcfg, pcfg, _, _ = _setup()
    jc = jax_encdec.init_cache(jcfg, 3, 24)
    pc = pt_encdec.init_cache(pcfg, 3, 24, device="cpu")
    assert set(pc) == set(jc)
    for k in jc:
        assert tuple(pc[k].shape) == tuple(jc[k].shape), k
        assert not bool(pc[k].any())


def test_prefill_and_decode_steps_match_jax():
    jcfg, pcfg, jparams, pparams = _setup()
    fr, toks = _frames(4, 3), _tokens(5, (3, 6))
    jc = jax_encdec.prefill(jparams, jcfg, jnp.asarray(fr),
                            jax_encdec.init_cache(jcfg, 3, 24))
    pc = pt_encdec.prefill(pparams, pcfg, torch.from_numpy(fr),
                           pt_encdec.init_cache(pcfg, 3, 24, device="cpu"))
    for k in ("cross_k", "cross_v"):
        _close(jc[k], pc[k])
    step = jax.jit(lambda c, t: jax_encdec.decode_step(jparams, jcfg, t, c))
    for i in range(toks.shape[1]):
        jl, jc = step(jc, jnp.asarray(toks[:, i]))
        pl, pc = pt_encdec.decode_step(pparams, pcfg,
                                       torch.from_numpy(toks[:, i]), pc)
        _close(jl, pl)
    for k in ("k", "v"):
        _close(jc[k], pc[k])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), pc["pos"].numpy())


def test_decode_past_the_learned_positions_matches_jax():
    """Rows at positions max_seq_len - 1 and max_seq_len (128 in the
    smoke config; a cache of max_seq_len + 4), stepped 3 times: the
    learned position clamps to the table's last row, as the reference's
    gather does, and the logits are finite and equal the reference's."""
    jcfg, pcfg, jparams, pparams = _setup()
    s = pcfg.max_seq_len
    fr, toks = _frames(11, 2), _tokens(12, (2, 3))
    jc = jax_encdec.prefill(jparams, jcfg, jnp.asarray(fr),
                            jax_encdec.init_cache(jcfg, 2, s + 4))
    pc = pt_encdec.prefill(pparams, pcfg, torch.from_numpy(fr),
                           pt_encdec.init_cache(pcfg, 2, s + 4,
                                                device="cpu"))
    start = np.array([s - 1, s], np.int32)
    jc = dict(jc, pos=jnp.asarray(start))
    pc = dict(pc, pos=torch.from_numpy(start))
    for i in range(toks.shape[1]):
        jl, jc = jax_encdec.decode_step(jparams, jcfg,
                                        jnp.asarray(toks[:, i]), jc)
        pl, pc = pt_encdec.decode_step(pparams, pcfg,
                                       torch.from_numpy(toks[:, i]), pc)
        assert bool(torch.isfinite(pl).all())
        _close(jl, pl)
    for k in ("k", "v"):
        _close(jc[k], pc[k])


def test_decode_equals_teacher_forced_forward():
    """A greedy decode loop after the prefill, then ``forward`` on the
    tokens it fed: the same logits at every position."""
    _, pcfg, _, pparams = _setup()
    fr = torch.from_numpy(_frames(6, 2))
    cache = pt_encdec.prefill(pparams, pcfg, fr, pt_encdec.init_cache(
        pcfg, 2, 16, device="cpu"))
    tok = torch.tensor([1, 7], dtype=torch.int32)
    fed, logits = [], []
    for _ in range(10):
        fed.append(tok)
        out, cache = pt_encdec.decode_step(pparams, pcfg, tok, cache)
        logits.append(out)
        tok = out[:, :pcfg.vocab_size].argmax(-1).to(torch.int32)
    teacher = pt_encdec.forward(pparams, pcfg, fr, torch.stack(fed, 1))
    _close(teacher.numpy(), torch.stack(logits, 1))


def test_decode_row_is_independent_of_batch():
    """A row stepped in a batch of 8 equals the row stepped alone from the
    same prefill (its cross k / v), logits and self-attention cache."""
    _, pcfg, _, pparams = _setup()
    fr = torch.from_numpy(_frames(8, 8))
    c8 = pt_encdec.prefill(pparams, pcfg, fr, pt_encdec.init_cache(
        pcfg, 8, 16, device="cpu"))
    c1 = {k: v[3:4].clone() if k == "pos" else v[:, 3:4].clone()
          for k, v in c8.items()}
    toks = torch.from_numpy(_tokens(9, (8, 5)))
    for t in range(toks.shape[1]):
        l8, c8 = pt_encdec.decode_step(pparams, pcfg, toks[:, t], c8)
        l1, c1 = pt_encdec.decode_step(pparams, pcfg, toks[3:4, t], c1)
        assert torch.equal(l8[3:4], l1), t
    for k in ("k", "v"):
        assert torch.equal(c8[k][:, 3:4], c1[k]), k
