"""Port parity for the hybrid trunk: zamba2-2.7b (smoke: 4 SSD layers,
d64, d_state 16, head_dim 16, chunk 8, and one shared attention block of
4 heads of 16 with a GeGLU MLP applied after every 2 of them; vocab 512,
fp32), trained, prefilled and served.

The JAX params are bridged into the port and the same numpy-seeded inputs
go through both packages.  Logits, caches and losses at atol = rtol =
1e-5 (the same fp32 arithmetic, sums in another order); gradients -- the
shared block's summed over its applications -- and the 5-step trajectory
at the tolerances of ``test_torch_training.py`` (grads rtol 1e-4 / atol
1e-5; per-step metrics rtol 1e-4; final params rtol 1e-3 / atol 1e-4).
A right-padded row's prefill is held against its own prefill at
atol = rtol = 1e-5: the shared block's attention sums a row's scores over
the batch's longest prompt, its masked positions adding exact zeros in
another grouping (``tests/test_serving.py`` holds the reference's exact,
and that case is red in the reference).  Greedy streams must equal the
JAX ``generate_one`` token for token, seeded sampled streams the JAX
engine's.
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
from repro.models import lm as jax_lm
from repro.serving import engine as jax_engine
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro_torch import bridge, tree
from repro_torch.configs import archs as pt_archs
from repro_torch.models import lm as pt_lm
from repro_torch.serving import engine as pt_engine
from repro_torch.serving import recovery
from repro_torch.serving.faults import FaultInjector
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as pt_opt
from repro_torch.training import train_step as pt_ts

ARCH = "zamba2-2.7b"
TOL = 1e-5
MAX_LEN = 64
# tests/test_serving.py's prompts for the engine against generate_one
PROMPTS = ([1, 2, 3, 4], [5, 6, 7], [2, 4, 6, 8, 10, 1])
MAX_NEW = 6
CACHE_KEYS = {"pos", "conv", "ssm", "k", "v"}


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, pcfg = jax_archs.smoke(ARCH), pt_archs.smoke(ARCH)
    jparams = jax.jit(jax_lm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, pcfg, jparams, pparams


@functools.lru_cache(maxsize=None)
def _refs():
    jcfg, _, jparams, _ = _setup()
    return tuple(tuple(jax_engine.generate_one(jcfg, jparams, p,
                                               max_new=MAX_NEW,
                                               max_len=MAX_LEN))
                 for p in PROMPTS)


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


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


_CORPUS = {}


def _batch(step, batch=2, seq=16):
    if "train" not in _CORPUS:
        _CORPUS["train"] = jax_corpus.build_corpus(target_bytes=20_000)[0]
    return jax_corpus.lm_batch(_CORPUS["train"], 0, step, batch, seq)


# ---------------------------------------------------------------------------
# Config and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("get", ["get", "smoke"])
def test_config_equals_reference(get):
    j = getattr(jax_archs, get)(ARCH)
    p = getattr(pt_archs, get)(ARCH)
    for f in dataclasses.fields(p):
        if f.name != "ssm":
            assert getattr(j, f.name) == getattr(p, f.name), (get, f.name)
    assert dataclasses.asdict(j.ssm) == dataclasses.asdict(p.ssm)
    assert (j.head_dim_, j.padded_vocab) == (p.head_dim_, p.padded_vocab)
    if get == "get":
        s = p.ssm
        assert (p.n_layers, p.hybrid_attn_every, p.d_model,
                s.d_inner(p.d_model), s.n_heads(p.d_model), s.head_dim,
                s.d_state, p.n_heads, p.head_dim_, p.d_ff,
                p.mlp_activation, p.vocab_size, p.tie_embeddings,
                p.compute_dtype, p.remat) == \
            (54, 6, 2560, 5120, 80, 64, 64, 32, 80, 10240, "gelu", 32000,
             False, "bfloat16", "full")


def test_bridged_params_and_own_init_share_the_tree():
    _, pcfg, jparams, pparams = _setup()
    assert len(jax.tree_util.tree_leaves_with_path(jparams)) == \
        len(tree.leaves(pparams))
    own = pt_lm.init_params(torch.Generator().manual_seed(0), pcfg,
                            device="cpu")
    got = {p: (tuple(a.shape), a.dtype) for p, a in tree.leaves_with_path(own)}
    want = {p: (tuple(a.shape), a.dtype)
            for p, a in tree.leaves_with_path(pparams)}
    assert got == want
    assert got[("layers", "blocks", "mixer", "a_log")][0][0] == 4
    assert got[("layers", "shared_attn", "mixer", "wq", "kernel")][0] == \
        (64, 64)                                # one block, not stacked
    assert pt_lm.kernel_tier(pcfg) == "unfused"
    layers = pt_lm.bind_layers(own, pcfg)
    assert len(layers) == 4 and all(b is None for _, b in layers)


def test_layers_not_a_multiple_of_the_period_are_refused():
    cfg = pt_archs.smoke(ARCH).replace(n_layers=3)
    with pytest.raises(ValueError, match="multiple of hybrid_attn_every"):
        pt_lm.init_cache(cfg, 1, 8, device="cpu")


# ---------------------------------------------------------------------------
# The parallel trunk: logits, loss, gradients, training
# ---------------------------------------------------------------------------

def test_forward_logits_match_jax():
    jcfg, pcfg, jparams, pparams = _setup()
    toks = _tokens(1, (2, 19))                  # T 19: off the chunk of 8
    want, _ = jax.jit(lambda p, t: jax_lm.forward(p, jcfg, t))(
        jparams, jnp.asarray(toks))
    got, aux = pt_lm.forward(pparams, pcfg, torch.from_numpy(toks))
    _close(want, got)
    assert float(aux) == 0.0


def test_loss_and_grads_match_jax():
    """Every gradient, the shared block's summed over its two
    applications."""
    jcfg, pcfg, jparams, pparams = _setup()
    jcfg, pcfg = jcfg.replace(z_loss=1e-4), pcfg.replace(z_loss=1e-4)
    batch = _batch(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm.loss_fn(p, jcfg, b), has_aux=True))(
        jparams, batch)
    pp = tree.tree_map(torch.clone, pparams)
    (pl, pm), pg = pt_ts.value_and_grad(pt_ts.make_loss_fn(pcfg), pp,
                                        pt_ts.batch_to(batch, "cpu"))
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL)
    np.testing.assert_allclose(float(pm["z_loss"]), float(jm["z_loss"]),
                               rtol=TOL)
    assert "moe_aux" not in pm
    _trees_close(jg, pg, rtol=1e-4, atol=1e-5)


def test_remat_full_matches_no_remat():
    """The remat unit is the group (2 SSD layers and the shared block)."""
    _, pcfg, _, pparams = _setup()
    batch = pt_ts.batch_to(_batch(1), "cpu")
    outs = []
    for remat in ("none", "full"):
        pp = tree.tree_map(torch.clone, pparams)
        outs.append(pt_ts.value_and_grad(
            pt_ts.make_loss_fn(pcfg.replace(remat=remat)), pp, batch))
    (l0, _), g0 = outs[0]
    (l1, _), g1 = outs[1]
    assert float(l0) == float(l1)
    for (k, a), (_, b) in zip(_flat(g0), _flat(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(k))


def test_five_step_trajectory_matches_jax():
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
# Decode: the cache, the step, the prefill
# ---------------------------------------------------------------------------

def test_init_cache_and_decode_steps_match_jax():
    jcfg, pcfg, jparams, pparams = _setup()
    jc = jax_lm.init_cache(jcfg, 3, MAX_LEN)
    pc = pt_lm.init_cache(pcfg, 3, MAX_LEN, device="cpu")
    assert set(pc) == set(jc) == CACHE_KEYS
    for k in pc:
        assert tuple(pc[k].shape) == jc[k].shape, k
        assert pc[k].dtype == bridge.leaf_from_numpy(
            np.asarray(jc[k])).dtype, k
    assert pc["k"].shape[0] == 2 and pc["ssm"].shape[0] == 4
    step = jax.jit(lambda c, t: jax_lm.decode_step(jparams, jcfg, t, c))
    for i in range(4):
        t = _tokens(10 + i, (3,))
        jl, jc = step(jc, jnp.asarray(t))
        pl, pc = pt_lm.decode_step(pparams, pcfg, torch.from_numpy(t), pc)
        _close(jl, pl)
    for k in ("conv", "ssm", "k", "v"):
        _close(jc[k], pc[k])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), pc["pos"].numpy())


def test_decode_row_is_independent_of_batch():
    """A row stepped in a batch of 11 (two row groups, the second padded,
    its KV rows copied out and back) equals the row stepped alone, bit
    for bit, and the first group's KV rows are written in place."""
    _, pcfg, _, pparams = _setup()
    toks = torch.from_numpy(_tokens(3, (11, 4)))
    cb = pt_lm.init_cache(pcfg, 11, MAX_LEN, device="cpu")
    c1 = pt_lm.init_cache(pcfg, 1, MAX_LEN, device="cpu")
    k_ptr = cb["k"].data_ptr()
    for t in range(toks.shape[1]):
        lb, cb = pt_lm.decode_step(pparams, pcfg, toks[:, t], cb)
        l1, c1 = pt_lm.decode_step(pparams, pcfg, toks[9:10, t], c1)
        assert torch.equal(lb[9:10], l1), t
    assert cb["k"].data_ptr() == k_ptr
    for k in ("conv", "ssm", "k", "v"):
        assert torch.equal(cb[k][:, 9:10], c1[k]), k


@pytest.mark.parametrize("padded", [False, True])
def test_prefill_then_decode_matches_jax(padded):
    jcfg, pcfg, jparams, pparams = _setup()
    toks = _tokens(2, (3, 11))
    lengths = np.array([11, 4, 1], np.int32) if padded else None
    jkw = {} if lengths is None else {"lengths": jnp.asarray(lengths)}
    pkw = {} if lengths is None else {"lengths": torch.from_numpy(lengths)}
    jl, jc = jax.jit(lambda p, t, kw: jax_lm.prefill(p, jcfg, t, 16, **kw))(
        jparams, jnp.asarray(toks), jkw)
    pl, pc = pt_lm.prefill(pparams, pcfg, torch.from_numpy(toks), 16, **pkw)
    assert set(pc) == set(jc) == CACHE_KEYS
    _close(jl, pl)
    for k in ("conv", "ssm", "k", "v"):
        _close(jc[k], pc[k])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), pc["pos"].numpy())
    step = jax.jit(lambda c, t: jax_lm.decode_step(jparams, jcfg, t, c))
    for i in range(3):
        t = _tokens(10 + i, (3,))
        jl, jc = step(jc, jnp.asarray(t))
        pl, pc = pt_lm.decode_step(pparams, pcfg, torch.from_numpy(t), pc)
        _close(jl, pl)


_PAD_PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [2, 4, 6, 8, 10, 1, 3, 7, 9]]


def test_padded_prefill_rows_match_their_own_prefill():
    """tests/test_serving.py's padding invariance for zamba2-2.7b at
    atol = rtol = 1e-5: each right-padded row's logits, conv / ssm state
    and its KV rows up to its length against its own unpadded prefill,
    and the batched prefill against the JAX one; the greedy token
    equal."""
    jcfg, pcfg, jparams, pparams = _setup()
    toks = np.zeros((3, 12), np.int32)
    for i, p in enumerate(_PAD_PROMPTS):
        toks[i, :len(p)] = p
    lengths = np.array([len(p) for p in _PAD_PROMPTS], np.int32)
    lg_b, cache_b = pt_lm.prefill(pparams, pcfg, torch.from_numpy(toks),
                                  MAX_LEN, lengths=torch.from_numpy(lengths))
    jl, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), MAX_LEN,
                            lengths=jnp.asarray(lengths))
    _close(jl, lg_b)
    for k in ("conv", "ssm"):
        _close(jc[k], cache_b[k])
    for i, p in enumerate(_PAD_PROMPTS):
        lg1, c1 = pt_lm.prefill(pparams, pcfg,
                                torch.tensor([p], dtype=torch.int32), MAX_LEN)
        for k in ("conv", "ssm"):
            torch.testing.assert_close(cache_b[k][:, i], c1[k][:, 0],
                                       rtol=TOL, atol=TOL)
        for k in ("k", "v"):
            torch.testing.assert_close(cache_b[k][:, i, :len(p)],
                                       c1[k][:, 0, :len(p)], rtol=TOL,
                                       atol=TOL)
        torch.testing.assert_close(lg_b[i], lg1[0], rtol=TOL, atol=TOL)
        assert int(lg_b[i].argmax()) == int(lg1[0].argmax())
        assert int(cache_b["pos"][i]) == len(p)


def test_prefill_then_decode_equals_generate_one():
    jcfg, pcfg, jparams, pparams = _setup()
    for prompt in ([1, 2, 3, 4], [2] * 9):
        logits, cache = pt_lm.prefill(
            pparams, pcfg, torch.tensor([prompt], dtype=torch.int32), MAX_LEN)
        par = [int(logits[0, :pcfg.vocab_size].argmax())]
        for _ in range(5):
            logits, cache = pt_lm.decode_step(
                pparams, pcfg, torch.tensor([par[-1]], dtype=torch.int32),
                cache)
            par.append(int(logits[0, :pcfg.vocab_size].argmax()))
        assert par == jax_engine.generate_one(jcfg, jparams, prompt,
                                              max_new=6, max_len=MAX_LEN)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _engine(pcfg, pparams, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", MAX_LEN)
    return pt_engine.ServingEngine(pcfg, pparams, device="cpu", **kw)


@pytest.mark.parametrize("k", [1, 4])
def test_engine_greedy_streams_equal_jax_generate_one(k):
    _, pcfg, _, pparams = _setup()
    eng = _engine(pcfg, pparams, decode_block=k)
    assert eng.kernel_tier == "unfused"
    rids = [eng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    outs = eng.run_to_completion()
    assert tuple(tuple(outs[r]) for r in rids) == _refs()
    assert eng.stats.shard_identities_ok()
    assert tuple(pt_engine.generate_one(pcfg, pparams, p, max_new=MAX_NEW,
                                        max_len=MAX_LEN, device="cpu")
                 for p in PROMPTS) == tuple(map(list, _refs()))


def test_sampled_streams_equal_jax_engine():
    jcfg, pcfg, jparams, pparams = _setup()
    kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    jeng = jax_engine.ServingEngine(jcfg, jparams, max_batch=2,
                                    max_len=MAX_LEN, decode_block=2, seed=7)
    jr = [jeng.submit(p, max_new=MAX_NEW, **kw) for p in PROMPTS]
    jouts = jeng.run_to_completion()
    eng = _engine(pcfg, pparams, decode_block=2, seed=7)
    pr = [eng.submit(p, max_new=MAX_NEW, **kw) for p in PROMPTS]
    pouts = eng.run_to_completion()
    assert [pouts[r] for r in pr] == [jouts[r] for r in jr]


def test_packing_speculation_resume_and_autotune_are_refused():
    jcfg, pcfg, jparams, pparams = _setup()
    assert not pt_lm.supports_prompt_packing(pcfg)
    assert not jax_lm.supports_prompt_packing(jcfg)
    assert not pt_lm.supports_chunked_prefill(pcfg)
    with pytest.raises(ValueError, match="prompt_chunk"):
        _engine(pcfg, pparams, prompt_chunk=4)
    with pytest.raises(ValueError, match="speculative"):
        _engine(pcfg, pparams, speculative="ngram")
    state = pt_lm.init_slot_state(pcfg, 2, MAX_LEN, device="cpu")
    for kw in ({"prompt_chunk": 4}, {"draft": object()}):
        with pytest.raises(NotImplementedError, match="minrnn"):
            pt_lm.superstep(pparams, pcfg, state, 2, **kw)
    one = torch.ones((2, 3), dtype=torch.int32)
    valid = torch.full((2,), 3, dtype=torch.int32)
    for fn in (pt_lm.decode_chunk, pt_lm.decode_verify):
        with pytest.raises(NotImplementedError, match="minrnn"):
            fn(pparams, pcfg, one, valid, state["cache"])
    _, cache = pt_lm.prefill(pparams, pcfg, one, MAX_LEN)
    with pytest.raises(NotImplementedError, match="resume"):
        pt_lm.prefill(pparams, pcfg, one, MAX_LEN, cache=cache)
    from repro_torch.serving import autotune
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        autotune.sweep(ARCH, smoke=True, device="cpu", points=1)


def test_rearm_zeroes_the_ssm_state_and_leaves_the_kv_cache():
    _, pcfg, _, _ = _setup()
    cache = pt_lm.init_slot_state(pcfg, 3, 16, device="cpu")["cache"]
    cache = {k: (torch.randn(v.shape) if k != "pos" else
                 torch.tensor([4, 5, 6], dtype=torch.int32))
             for k, v in cache.items()}
    out = pt_lm._reset_slot_rows(cache, torch.tensor([True, False, True]))
    for k in ("ssm", "conv"):
        assert not out[k][:, [0, 2]].any()
        assert torch.equal(out[k][:, 1], cache[k][:, 1])
    for k in ("k", "v"):
        assert out[k] is cache[k]
    assert out["pos"].tolist() == [0, 5, 0]


def _trace(n, seed):
    rng = np.random.default_rng(seed)
    return sorted(
        (dict(arrival=int(rng.integers(0, 3 * n)),
              prompt=[int(x) for x in rng.integers(1, 500,
                                                   size=int(rng.integers(2, 6)))],
              max_new=int(rng.integers(3, 8))) for _ in range(n)),
        key=lambda r: r["arrival"])


def _submitter(eng):
    def fn(i, r):
        eng.submit(r["prompt"], max_new=r["max_new"],
                   temperature=0.0 if i % 2 == 0 else 0.8,
                   top_k=0 if i % 2 == 0 else 40)
    return fn


def _outs(eng):
    return {rid: req.out for rid, req in sorted(eng.finished.items())}


def test_hybrid_engine_kill_restore_bit_identical(tmp_path):
    """Snapshots carry all four cache leaves (conv, ssm, k, v): a killed
    zamba2 engine restored from its newest snapshot and the journal's
    tail finishes with the uninterrupted run's streams and round clock."""
    _, pcfg, _, pparams = _setup()
    trace = _trace(6, seed=2)
    ref = _engine(pcfg, pparams)
    pt_engine.replay_trace(ref, trace, _submitter(ref))
    eng = _engine(pcfg, pparams, recover_dir=str(tmp_path), snapshot_every=3)
    pt_engine.replay_trace(eng, trace, _submitter(eng),
                           stop=lambda e: e.stats.decode_steps >= 7)
    assert len(eng.finished) < len(trace)
    eng.journal.close()
    del eng
    rec = pt_engine.ServingEngine.restore(str(tmp_path), pcfg, pparams,
                                          device="cpu")
    assert rec.recovery_report["snapshot_round"] is not None
    pt_engine.replay_trace(rec, trace, _submitter(rec),
                           start=len(rec.requests))
    assert _outs(rec) == _outs(ref)
    assert rec.stats.decode_steps == ref.stats.decode_steps
    arrays, _ = recovery.snapshot_engine(rec)
    for k in ("conv", "ssm", "k", "v"):
        leaf = arrays[ckpt.SEP.join(("state", "cache", k))]
        assert torch.equal(leaf, rec.state["cache"][k]), k


_COUNTERS = ("completed", "failed", "quarantined", "retried", "slot_steps",
             "prefill_rounds", "decode_tokens", "wasted_slot_steps",
             "nonfinite_decode_rounds")


def _fault_outcome(eng):
    return {"events": [tuple(e) for e in eng.faults.events],
            "requests": {rid: (r.status, list(r.out), r.retries)
                         for rid, r in sorted(eng.requests.items())},
            "counters": {c: getattr(eng.stats, c) for c in _COUNTERS}}


def test_hybrid_engine_under_faults_matches_the_jax_engine():
    """Dropped uploads and NaN poured into two slots' ssm / conv state,
    on both engines under one injector seed: the same events, statuses,
    outputs, retries and round counters.  The poisoned rows are
    quarantined and retried, and the completed streams equal
    generate_one's.  As in the reference, the NaN state also writes NaN k
    / v into the slot's KV rows past the new request's position, and the
    attention's PV product reads them (0 x NaN): the request served in
    that slot next fails after its retry, in both engines."""
    from repro.serving.faults import FaultInjector as JaxFaultInjector
    jcfg, pcfg, jparams, pparams = _setup()
    kw = dict(seed=3, drop_rate=0.3, nan_at=((2, 0), (3, 1)))
    outcomes = []
    for eng in (jax_engine.ServingEngine(
                    jcfg, jparams, max_batch=2, max_len=MAX_LEN,
                    decode_block=2, faults=JaxFaultInjector(**kw)),
                _engine(pcfg, pparams, decode_block=2,
                        faults=FaultInjector(**kw))):
        for p in PROMPTS:
            eng.submit(p, max_new=MAX_NEW)
        eng.run_to_completion()
        outcomes.append(_fault_outcome(eng))
    assert outcomes[1] == outcomes[0]
    counts = eng.faults.counts()
    assert counts["drop_upload"] > 0 and counts["corrupt_state"] > 0
    assert eng.stats.retried > 0
    done = {rid: r.out for rid, r in eng.requests.items()
            if r.status == pt_engine.COMPLETED}
    assert len(done) == 2
    for rid, out in done.items():
        assert tuple(out) == _refs()[rid]


def test_serve_and_train_launchers_run_zamba2_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve, train
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--prompts", "To be", "Hi", "--max-new", "4",
                "--decode-block", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "kernel tier: unfused" in out and "superstep K=2" in out
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--prompts", "To be", "--max-new", "3", "--prefill",
                "--max-len", "32"])
    assert "prefill:" in capsys.readouterr().out
    report = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "16",
                         "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    assert report.failures_recovered == 0
    assert "step 2:" in capsys.readouterr().out
