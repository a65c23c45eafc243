"""Port parity for speculative decoding: ``serving/draft.py``,
``lm.decode_verify``, the speculative superstep, ``sampling.sample_chain``
and the engine's ``speculative=`` options (the port of
``tests/test_speculative.py``).

Speculation may change only when tokens are emitted, never which: every
draft source streams bit for bit as the non-speculative port engine and
as the JAX speculative engine on the same (bridged) weights, greedy and
seeded; rollback is exact at first-token rejection, full acceptance and
an EOS inside an accepted run; the ``EngineStats`` identities hold.  The
JAX side runs its Pallas kernels in interpret mode, the port the kernels'
plain versions (CPU tensors).  Verify logits and per-position states are
held to fp32 atol = rtol = 3e-5; ``sample_chain``'s tokens and keys bit
for bit.
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
from repro.serving import draft as jax_draft
from repro.serving import engine as jax_engine
from repro.serving import sampling as jax_sampling
from repro_torch import bridge
from repro_torch.configs import archs as pt_archs
from repro_torch.models import lm as pt_lm
from repro_torch.serving import draft as pt_draft
from repro_torch.serving import engine as pt_engine
from repro_torch.serving import sampling as pt_sampling

MAX_LEN = 64
TOL = 3e-5


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=0):
    jcfg = jax_archs.smoke(arch)
    pcfg = pt_archs.smoke(arch)
    jparams = jax_lm.init_params(jax.random.PRNGKey(seed), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, pcfg, jparams, pparams


def _prompts(n, seed=0, lo=2, hi=14):
    """The reference test's prompts (random byte ids), plus a repeated
    phrase in every second one so that n-grams recur."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = [int(t) for t in rng.integers(1, 250,
                                          size=int(rng.integers(lo, hi)))]
        out.append(p * 3 if i % 2 else p)
    return out


def _run_port(pcfg, pparams, prompts, max_new=10, *, eos=None,
              temperature=0.0, seed=0, **kw):
    eng = pt_engine.ServingEngine(pcfg, pparams, max_batch=3,
                                  max_len=MAX_LEN, seed=seed, device="cpu",
                                  **kw)
    rids = [eng.submit(p, max_new=max_new, temperature=temperature,
                       top_k=0, top_p=1.0, eos=eos) for p in prompts]
    outs = eng.run_to_completion()
    return [list(outs[r]) for r in rids], eng


def _run_jax(jcfg, jparams, prompts, max_new=10, *, eos=None,
             temperature=0.0, seed=0, **kw):
    eng = jax_engine.ServingEngine(jcfg, jparams, max_batch=3,
                                   max_len=MAX_LEN, seed=seed, **kw)
    rids = [eng.submit(p, max_new=max_new, temperature=temperature,
                       top_k=0, top_p=1.0, eos=eos) for p in prompts]
    outs = eng.run_to_completion()
    return [list(outs[r]) for r in rids], eng


@functools.lru_cache(maxsize=None)
def _base(arch, prompt_seed, temperature=0.0, seed=0, max_new=10):
    """The non-speculative port engine's streams (as tuples)."""
    _, pcfg, _, pparams = _pair(arch)
    outs, _ = _run_port(pcfg, pparams, _prompts(5, prompt_seed),
                        max_new=max_new, temperature=temperature, seed=seed)
    return tuple(tuple(o) for o in outs)


def _stats_ok(st, outs):
    assert st.decode_tokens == sum(len(o) for o in outs)
    assert st.decode_tokens == st.draft_accepted + st.non_spec_tokens
    assert st.slot_steps == (st.prefill_rounds + st.non_spec_tokens
                             - len(st.ttft_rounds) + st.wasted_slot_steps)
    assert st.shard_identities_ok()


# ---------------------------------------------------------------------------
# Stream parity: speculative == non-speculative == the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mingru-lm", "minlstm-lm"])
@pytest.mark.parametrize("k,c,s", [(1, 1, 1), (4, 2, 3), (3, 4, 4),
                                   (8, 1, 2)])
def test_ngram_greedy_streams_bitexact(arch, k, c, s):
    jcfg, pcfg, jparams, pparams = _pair(arch)
    seed = int(arch == "minlstm-lm")
    prompts = _prompts(5, seed)
    spec, eng = _run_port(pcfg, pparams, prompts, speculative="ngram",
                          draft_len=s, decode_block=k, prompt_chunk=c)
    assert tuple(tuple(o) for o in spec) == _base(arch, seed)
    ref, jeng = _run_jax(jcfg, jparams, prompts, speculative="ngram",
                         draft_len=s, decode_block=k, prompt_chunk=c)
    assert spec == ref
    assert eng.stats.draft_proposed == jeng.stats.draft_proposed > 0
    assert eng.stats.draft_accepted == jeng.stats.draft_accepted
    _stats_ok(eng.stats, spec)


@pytest.mark.parametrize("source", ["fixed", "oracle"])
def test_other_sources_greedy_streams_bitexact(source):
    jcfg, pcfg, jparams, pparams = _pair("mingru-lm")
    prompts = _prompts(5, 2)
    if source == "fixed":
        pd, jd = pt_draft.FixedDraft(251, 3), jax_draft.FixedDraft(251, 3)
    else:
        pd = pt_draft.ModelDraft(pcfg, pparams, draft_len=3)
        jd = jax_draft.ModelDraft(jcfg, jparams, draft_len=3)
    spec, eng = _run_port(pcfg, pparams, prompts, speculative=pd,
                          decode_block=4, prompt_chunk=2)
    assert tuple(tuple(o) for o in spec) == _base("mingru-lm", 2)
    ref, jeng = _run_jax(jcfg, jparams, prompts, speculative=jd,
                         decode_block=4, prompt_chunk=2)
    assert spec == ref
    assert eng.stats.draft_accepted == jeng.stats.draft_accepted


@pytest.mark.parametrize("arch", ["mingru-lm", "minlstm-lm"])
def test_seeded_sampling_unchanged_under_speculation(arch):
    """Emission-aligned keys: a request's k-th output token uses the k-th
    key of its slot's chain whichever round emits it, so seeded streams
    equal the non-speculative port engine's and the JAX speculative
    engine's."""
    jcfg, pcfg, jparams, pparams = _pair(arch)
    prompts = _prompts(4, 3)
    base, _ = _run_port(pcfg, pparams, prompts, temperature=0.8, seed=7)
    for s in (1, 3):
        kw = dict(temperature=0.8, seed=7, speculative="ngram",
                  draft_len=s, decode_block=3, prompt_chunk=2)
        spec, _ = _run_port(pcfg, pparams, prompts, **kw)
        assert spec == base, f"draft_len={s}"
        ref, _ = _run_jax(jcfg, jparams, prompts, **kw)
        assert spec == ref, f"draft_len={s}"


def test_draft_model_params_bridged_from_jax():
    """A draft model of its own (another seed), its JAX params carried
    across with ``params_from_jax`` like the target's: streams unchanged,
    and the port accepts exactly the drafts the JAX engine accepts."""
    jcfg, pcfg, jparams, pparams = _pair("mingru-lm")
    djcfg, dpcfg, djparams, dpparams = _pair("minlstm-lm", seed=1)
    prompts = _prompts(4, 6)
    base, _ = _run_port(pcfg, pparams, prompts)
    spec, eng = _run_port(pcfg, pparams, prompts,
                          speculative=pt_draft.ModelDraft(dpcfg, draft_len=3),
                          draft_params=dpparams, decode_block=4)
    assert spec == base
    ref, jeng = _run_jax(jcfg, jparams, prompts,
                         speculative=jax_draft.ModelDraft(djcfg, draft_len=3),
                         draft_params=djparams, decode_block=4)
    assert spec == ref
    assert (eng.stats.draft_proposed, eng.stats.draft_accepted) == \
        (jeng.stats.draft_proposed, jeng.stats.draft_accepted)


# ---------------------------------------------------------------------------
# Rollback extremes
# ---------------------------------------------------------------------------

def test_first_token_rejection_rolls_back_exactly():
    _, pcfg, _, pparams = _pair("mingru-lm")
    prompts = _prompts(4, 4)
    base, _ = _run_port(pcfg, pparams, prompts)
    spec, eng = _run_port(pcfg, pparams, prompts,
                          speculative=pt_draft.FixedDraft(251, 4),
                          decode_block=4)
    assert spec == base
    assert eng.stats.draft_proposed > 0
    assert eng.stats.draft_accepted == 0
    assert eng.stats.non_spec_tokens == eng.stats.decode_tokens


def test_oracle_draft_full_acceptance():
    _, pcfg, _, pparams = _pair("mingru-lm")
    prompts = _prompts(4, 5)
    base, _ = _run_port(pcfg, pparams, prompts)
    spec, eng = _run_port(pcfg, pparams, prompts,
                          speculative=pt_draft.ModelDraft(pcfg, pparams, 3),
                          decode_block=4)
    assert spec == base
    assert eng.stats.draft_proposed > 0
    assert eng.stats.draft_accepted == eng.stats.draft_proposed
    snap = eng.stats.snapshot()
    assert snap["accept_rate"] == 1.0
    assert eng.stats.non_spec_tokens < eng.stats.decode_tokens
    assert snap["itl_rounds_mean"] < 1.0


def test_eos_inside_accepted_draft_truncates():
    _, pcfg, _, pparams = _pair("mingru-lm")
    prompts = _prompts(3, 3)
    base, _ = _run_port(pcfg, pparams, prompts, max_new=12)
    eos = next((t for o in base for j, t in enumerate(o)
                if j >= 2 and t not in o[:j]), None)
    assert eos is not None, "degenerate reference streams"
    ref, _ = _run_port(pcfg, pparams, prompts, max_new=12, eos=eos)
    spec, eng = _run_port(pcfg, pparams, prompts, max_new=12, eos=eos,
                          speculative=pt_draft.ModelDraft(pcfg, pparams, 4),
                          decode_block=4)
    assert spec == ref
    assert any(o and o[-1] == eos and len(o) < 12 for o in spec)
    assert eng.stats.completed == len(prompts)


# ---------------------------------------------------------------------------
# Stats identities, ETA, the accept-rate floor, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_kw", [
    dict(),
    dict(speculative="ngram", draft_len=3),
    dict(speculative="ngram", draft_len=3, prompt_chunk=4),
])
def test_stats_identities(spec_kw):
    _, pcfg, _, pparams = _pair("mingru-lm")
    outs, eng = _run_port(pcfg, pparams, _prompts(6, 7), decode_block=4,
                          **spec_kw)
    _stats_ok(eng.stats, outs)
    st = eng.stats
    if spec_kw.get("speculative"):
        assert st.draft_proposed > 0
        assert 0 <= st.draft_accepted <= st.draft_proposed
    else:
        assert st.draft_proposed == 0 and st.draft_accepted == 0


def test_row_eta_under_speculation():
    """The staging ETA charges only the prompt tokens the device has not
    consumed, and stays an upper bound on the rounds a speculating row
    still needs."""
    _, pcfg, _, pparams = _pair("mingru-lm")
    eng = pt_engine.ServingEngine(pcfg, pparams, max_batch=1,
                                  max_len=MAX_LEN, prompt_chunk=4,
                                  speculative="ngram", draft_len=3,
                                  device="cpu")
    prompt = list(range(1, 7)) * 2 + [1]               # 13 prompt tokens
    eng.submit(prompt, max_new=8)
    eng.step(n_tokens=1)          # the device consumed 4 of 13
    assert int(eng._prompt_pos[0]) == 4
    assert eng._row_eta(0) == -(-(13 - 4) // 4) + 8
    eng.step(n_tokens=1)
    assert eng._row_eta(0) == -(-(13 - 8) // 4) + 8
    rounds_before, eta = eng.stats.decode_steps, None
    while eng.current[0] is not None and not eng.current[0].done:
        eta = eng._row_eta(0) if eta is None else eta
        eng.step(n_tokens=1)
    assert eng.stats.decode_steps - rounds_before <= eta


def test_accept_floor_turns_drafting_off_and_streams_hold():
    _, pcfg, _, pparams = _pair("mingru-lm")
    prompts = _prompts(4, 4)
    base, _ = _run_port(pcfg, pparams, prompts, max_new=16)
    spec, eng = _run_port(pcfg, pparams, prompts, max_new=16,
                          speculative=pt_draft.FixedDraft(251, 3),
                          decode_block=1, spec_accept_floor=0.5,
                          spec_window=2)
    assert spec == base
    assert eng.stats.spec_disabled == 1
    assert not eng._spec_active


def test_speculation_refused_on_the_attention_trunk():
    _, pcfg, _, pparams = _pair("gemma-2b-mingru")
    with pytest.raises(ValueError, match="recurrent-state"):
        pt_engine.ServingEngine(pcfg, pparams, max_batch=2, max_len=16,
                                speculative="ngram", device="cpu")
    with pytest.raises(NotImplementedError, match="block_kind='minrnn'"):
        pt_lm.decode_verify(pparams, pcfg,
                            torch.ones((1, 2), dtype=torch.int32),
                            torch.ones((1,), dtype=torch.int32),
                            pt_lm.init_cache(pcfg, 1, 8, "cpu"))


# ---------------------------------------------------------------------------
# The pieces: sample_chain, decode_verify, propose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_sample_chain_bit_equal_to_jax(temperature):
    rng = np.random.default_rng(11)
    b, w, v = 4, 5, 256
    logits = (3 * rng.standard_normal((b, w, v))).astype(np.float32)
    temp = np.array([temperature, 1.3, temperature, 0.5], np.float32)
    top_k = np.array([0, 40, 5, 0], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.8], np.float32)
    keys_j = jax_sampling.make_keys(9, b)
    tj, kj = jax_sampling.sample_chain(jnp.asarray(logits), keys_j,
                                       jnp.asarray(temp), jnp.asarray(top_k),
                                       jnp.asarray(top_p))
    tp, kp = pt_sampling.sample_chain(
        torch.from_numpy(logits), pt_sampling.make_keys(9, b),
        torch.from_numpy(temp), torch.from_numpy(top_k),
        torch.from_numpy(top_p))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(kp.numpy(),
                                  np.asarray(kj).astype(np.int64))
    # position 0 is sample_tokens with the slot's current key
    t0, k0 = jax_sampling.sample_tokens(
        jnp.asarray(logits[:, 0]), keys_j, jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p))
    np.testing.assert_array_equal(tp[:, 0].numpy(), np.asarray(t0))
    np.testing.assert_array_equal(kp[:, 0].numpy(),
                                  np.asarray(k0).astype(np.int64))


def _verify_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(4, 5)).astype(np.int32)
    valid = np.array([5, 1, 3, 2], np.int32)
    pre = rng.integers(1, cfg.vocab_size, size=(4, 6)).astype(np.int32)
    return toks, valid, pre


@pytest.mark.parametrize("arch", ["mingru-lm", "minlstm-lm"])
@pytest.mark.parametrize("fuse_block", ["auto", "off"])
def test_decode_verify_matches_jax(arch, fuse_block):
    """Logits at every position and the per-position states against the
    JAX ``decode_verify`` on a cache a prefill seeded; the cache comes
    back untouched; the state at valid - 1 equals ``decode_chunk``'s."""
    jcfg, pcfg, jparams, pparams = _pair(arch)
    jcfg = jcfg.replace(fuse_block=fuse_block)
    pcfg = pcfg.replace(fuse_block=fuse_block)
    toks, valid, pre = _verify_inputs(jcfg, 12)
    _, jcache = jax_lm.prefill(jparams, jcfg, jnp.asarray(pre), MAX_LEN)
    _, pcache = pt_lm.prefill(pparams, pcfg, torch.from_numpy(pre), MAX_LEN)
    kept = {k: v.clone() for k, v in pcache.items()}
    lj, sj = jax_lm.decode_verify(jparams, jcfg, jnp.asarray(toks),
                                  jnp.asarray(valid), jcache)
    lp, sp = pt_lm.decode_verify(pparams, pcfg, torch.from_numpy(toks),
                                 torch.from_numpy(valid), pcache)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=TOL,
                               atol=TOL)
    assert set(sj) == set(sp) == {"h", "conv"}
    for k in sj:
        assert sp[k].shape == sj[k].shape
        np.testing.assert_allclose(sp[k].numpy(), np.asarray(sj[k]),
                                   rtol=TOL, atol=TOL)
    for k in kept:
        assert torch.equal(kept[k], pcache[k])
    lc, cc = pt_lm.decode_chunk(pparams, pcfg, torch.from_numpy(toks),
                                torch.from_numpy(valid), pcache)
    rows = torch.arange(4)
    g = torch.from_numpy(valid).long() - 1
    np.testing.assert_array_equal(lc.numpy(), lp[rows, g].numpy())
    for k in sp:
        np.testing.assert_array_equal(cc[k].numpy(), sp[k][:, rows, g].numpy())


def test_propose_leaves_the_draft_cache_unchanged():
    _, pcfg, _, pparams = _pair("mingru-lm")
    drf = pt_draft.ModelDraft(pcfg, pparams, draft_len=4)
    drf.bind(pparams)
    st = pt_lm.init_slot_state(pcfg, 3, MAX_LEN, draft=drf, device="cpu")
    _, cache = pt_lm.prefill(pparams, pcfg,
                             torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]],
                                          dtype=torch.int32), MAX_LEN)
    st["draft_cache"] = cache
    st["tok"] = torch.tensor([3, 6, 9], dtype=torch.int32)
    kept = {k: v.clone() for k, v in cache.items()}
    drafts, n_draft = drf.propose(pparams, st)
    assert drafts.shape == (3, 4) and n_draft.tolist() == [4, 4, 4]
    for k in kept:
        assert torch.equal(kept[k], st["draft_cache"][k])
    # the drafts are the greedy continuations of tok from that cache
    logits, _ = pt_lm.decode_step(pparams, pcfg, st["tok"], cache)
    assert drafts[:, 0].tolist() == logits.argmax(-1).tolist()


def test_ngram_proposal_matches_jax():
    jcfg = jax_archs.smoke("mingru-lm")
    pcfg = pt_archs.smoke("mingru-lm")
    jd, pd = jax_draft.NGramDraft(4, 2), pt_draft.NGramDraft(4, 2)
    rng = np.random.default_rng(13)
    buf = rng.integers(1, 6, size=(5, 24)).astype(np.int32)
    plen = np.array([10, 3, 20, 1, 8], np.int32)
    n_out = np.array([4, 0, 2, 0, 9], np.int32)
    jst = jax_lm.init_slot_state(jcfg, 5, 24, draft=jd)
    jst.update(prompt=jnp.asarray(buf), prompt_len=jnp.asarray(plen),
               n_out=jnp.asarray(n_out))
    pst = pt_lm.init_slot_state(pcfg, 5, 24, draft=pd, device="cpu")
    pst.update(prompt=torch.from_numpy(buf), prompt_len=torch.from_numpy(plen),
               n_out=torch.from_numpy(n_out))
    dj, nj = jd.propose(None, jst)
    dp, np_ = pd.propose(None, pst)
    np.testing.assert_array_equal(np_.numpy(), np.asarray(nj))
    mask = np.arange(4)[None] < np.asarray(nj)[:, None]
    np.testing.assert_array_equal(np.where(mask, dp.numpy(), 0),
                                  np.where(mask, np.asarray(dj), 0))
