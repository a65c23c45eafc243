"""Port parity for the native attention trunk: gemma-2b (MQA, kv 1) and
gemma-7b (MHA), GQA with RoPE and a KV cache; trained, prefilled and
served; and the attention trunk's training (gemma-2b-mingru, Fig. 2's
transformer).

The smoke configs (2 layers, d64, vocab 1024, fp32) are built in both
packages, the JAX params bridged into the port, and the same numpy-seeded
inputs go through both.  Logits, caches and losses at atol = rtol = 1e-5
(the same arithmetic, sums in another order); gradients and the 5-step
trajectories at the tolerances of ``test_torch_training.py`` (its
docstring says why).  Greedy streams must equal the JAX ``generate_one``
token for token, seeded sampled streams the JAX engine's.
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
from repro.configs import base as jax_base
from repro.data import lm_corpus as jax_corpus
from repro.models import lm as jax_lm
from repro.serving import engine as jax_engine
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro_torch import bridge, tree
from repro_torch.configs import archs as pt_archs
from repro_torch.configs import base as pt_base
from repro_torch.models import lm as pt_lm
from repro_torch.serving import engine as pt_engine
from repro_torch.serving import recovery
from repro_torch.serving.faults import FaultInjector
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as pt_opt
from repro_torch.training import train_step as pt_ts

ARCHS = ("gemma-2b", "gemma-7b")
TOL = 1e-5
MAX_LEN = 64
# tests/test_serving.py's prompts for the engine against generate_one
PROMPTS = ([1, 2, 3, 4], [5, 6, 7], [2, 4, 6, 8, 10, 1])
MAX_NEW = 6
# Fig. 2's transformer (benchmarks/fig2_lm.py), for both packages
FIG2 = dict(name="transformer", block_kind="attention", n_layers=3,
            d_model=64, n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=256,
            tie_embeddings=True, rope=True)


@functools.lru_cache(maxsize=None)
def _setup(arch, **over):
    jcfg = jax_archs.smoke(arch).replace(**over)
    pcfg = pt_archs.smoke(arch).replace(**over)
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, pcfg, jparams, pparams


@functools.lru_cache(maxsize=None)
def _refs(arch):
    jcfg, _, jparams, _ = _setup(arch)
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


def _tokens(seed, shape, vocab=1024):
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

@pytest.mark.parametrize("arch", ARCHS + ("gemma-2b-mingru",))
@pytest.mark.parametrize("get", ["get", "smoke"])
def test_config_equals_reference(arch, get):
    j = getattr(jax_archs, get)(arch)
    p = getattr(pt_archs, get)(arch)
    for f in dataclasses.fields(p):
        if f.name != "minrnn":
            assert getattr(j, f.name) == getattr(p, f.name), (get, f.name)
    assert (j.head_dim_, j.padded_vocab) == (p.head_dim_, p.padded_vocab)
    assert (j.minrnn is None) == (p.minrnn is None)
    if p.minrnn is not None:
        assert dataclasses.asdict(j.minrnn) == dataclasses.asdict(p.minrnn)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridged_params_and_own_init_share_the_tree(arch):
    _, pcfg, jparams, pparams = _setup(arch)
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == len(tree.leaves(pparams))
    paths = {".".join(k.key for k in path) for path, _ in flat}
    for leaf in ("wq", "wk", "wv", "wo"):
        assert f"layers.blocks.mixer.{leaf}.kernel" in paths, leaf
    own = pt_lm.init_params(torch.Generator().manual_seed(0), pcfg,
                            device="cpu")
    got = {p: (tuple(a.shape), a.dtype) for p, a in tree.leaves_with_path(own)}
    want = {p: (tuple(a.shape), a.dtype)
            for p, a in tree.leaves_with_path(pparams)}
    assert got == want
    assert pt_lm.kernel_tier(pcfg) == "unfused"


# ---------------------------------------------------------------------------
# The parallel trunk: logits, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tile", [1024, 4])
def test_forward_logits_match_jax(arch, tile):
    jcfg, pcfg, jparams, pparams = _setup(arch, attn_q_chunk=tile,
                                          attn_kv_chunk=tile)
    toks = _tokens(1, (2, 11))
    want, _ = jax_lm.forward(jparams, jcfg, jnp.asarray(toks))
    got, aux = pt_lm.forward(pparams, pcfg, torch.from_numpy(toks))
    _close(want, got)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, pcfg, jparams, pparams = _setup(arch, z_loss=1e-4)
    batch = _batch(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm.loss_fn(p, jcfg, b), has_aux=True))(
        jparams, batch)
    (pl, pm), pg = pt_ts.value_and_grad(pt_ts.make_loss_fn(pcfg), pparams,
                                        pt_ts.batch_to(batch, "cpu"))
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL)
    np.testing.assert_allclose(float(pm["z_loss"]), float(jm["z_loss"]),
                               rtol=TOL)
    _trees_close(jg, pg, rtol=1e-4, atol=1e-5)
    for leaf in tree.leaves(pparams):
        leaf.requires_grad_(False)


def test_remat_full_matches_no_remat():
    """Each layer under checkpoint, and the kv tiles under their own
    inside it: the same loss and gradients, bit for bit."""
    _, pcfg, _, pparams = _setup("gemma-2b")
    batch = pt_ts.batch_to(_batch(1), "cpu")
    outs = []
    for remat in ("none", "full"):
        cfg = pcfg.replace(remat=remat, attn_q_chunk=8, attn_kv_chunk=8)
        outs.append(pt_ts.value_and_grad(pt_ts.make_loss_fn(cfg), pparams,
                                         batch))
    (l0, _), g0 = outs[0]
    (l1, _), g1 = outs[1]
    assert float(l0) == float(l1)
    for (k, a), (_, b) in zip(_flat(g0), _flat(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(k))
    for leaf in tree.leaves(pparams):
        leaf.requires_grad_(False)


def _fig2_pair():
    jcfg = jax_base.ModelConfig(**FIG2)
    pcfg = pt_base.ModelConfig(**FIG2)
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, pcfg, jparams, bridge.params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma-2b-mingru", "fig2"])
def test_five_step_trajectory_matches_jax(arch):
    """gemma-2b-mingru's steps run the fused minGRU kernel's plain version
    and the reversed linear scan's here, the Pallas kernels in interpret
    mode on the JAX side."""
    if arch == "fig2":
        jcfg, pcfg, jparams, pparams = _fig2_pair()
    else:
        jcfg, pcfg, jparams, pparams = _setup(arch)
        jparams = jax.tree.map(jnp.array, jparams)       # the step donates
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
# Prefill with a seeded KV cache, then decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("padded", [False, True])
def test_prefill_then_decode_matches_jax(arch, padded):
    jcfg, pcfg, jparams, pparams = _setup(arch)
    toks = _tokens(2, (3, 9))
    lengths = np.array([9, 4, 1], np.int32) if padded else None
    jkw = {} if lengths is None else {"lengths": jnp.asarray(lengths)}
    pkw = {} if lengths is None else {"lengths": torch.from_numpy(lengths)}
    jl, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), 16, **jkw)
    pl, pc = pt_lm.prefill(pparams, pcfg, torch.from_numpy(toks), 16, **pkw)
    assert set(pc) == set(jc) == {"pos", "k", "v"}
    assert tuple(pc["k"].shape) == (2, 3, 16, pcfg.n_kv_heads, 32)
    _close(jl, pl)
    for k in ("k", "v"):
        _close(jc[k], pc[k])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), pc["pos"].numpy())
    step = jax.jit(lambda c, t: jax_lm.decode_step(jparams, jcfg, t, c))
    for i in range(3):
        t = _tokens(10 + i, (3,))
        jl, jc = step(jc, jnp.asarray(t))
        pl, pc = pt_lm.decode_step(pparams, pcfg, torch.from_numpy(t), pc)
        _close(jl, pl)
    for k in ("k", "v"):
        _close(jc[k], pc[k])


def test_prefill_then_decode_equals_generate_one():
    jcfg, pcfg, jparams, pparams = _setup("gemma-2b")
    for prompt in ([1, 2, 3, 4], [7, 5, 3], [2] * 9):
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


def test_prefill_longer_than_max_len_raises():
    _, pcfg, _, pparams = _setup("gemma-2b")
    with pytest.raises(ValueError, match="max_len"):
        pt_lm.prefill(pparams, pcfg, torch.ones((1, 9), dtype=torch.int32),
                      8)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _engine(pcfg, pparams, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", MAX_LEN)
    return pt_engine.ServingEngine(pcfg, pparams, device="cpu", **kw)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("k", [1, 4])
def test_engine_greedy_streams_equal_jax_generate_one(arch, k):
    _, pcfg, _, pparams = _setup(arch)
    eng = _engine(pcfg, pparams, decode_block=k)
    assert eng.kernel_tier == "unfused"
    rids = [eng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    outs = eng.run_to_completion()
    assert tuple(tuple(outs[r]) for r in rids) == _refs(arch)
    assert eng.stats.shard_identities_ok()
    assert tuple(pt_engine.generate_one(pcfg, pparams, p, max_new=MAX_NEW,
                                        max_len=MAX_LEN, device="cpu")
                 for p in PROMPTS) == tuple(map(list, _refs(arch)))


def test_engine_admission_order_independent():
    jcfg, pcfg, jparams, pparams = _setup("gemma-2b")
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 1, 4, 1, 5, 9], [2, 6]]
    refs = {tuple(p): jax_engine.generate_one(jcfg, jparams, p, max_new=5,
                                              max_len=MAX_LEN)
            for p in prompts}
    for order in ([0, 1, 2, 3], [3, 2, 1, 0], [2, 0, 3, 1]):
        eng = _engine(pcfg, pparams, max_batch=3, decode_block=2)
        rids = {eng.submit(prompts[i], max_new=5): tuple(prompts[i])
                for i in order}
        outs = eng.run_to_completion()
        for rid, key in rids.items():
            assert outs[rid] == refs[key], (order, key)


def test_engine_prompt_near_max_len():
    """A slot's KV rows past a finished request's positions stay in place
    when the slot re-arms; decode writes each position before it attends
    to it."""
    jcfg, pcfg, jparams, pparams = _setup("gemma-2b")
    prompt = list(range(1, 66))                 # 65 tokens, max_len 100
    ref = jax_engine.generate_one(jcfg, jparams, prompt, max_new=5,
                                  max_len=100)
    eng = _engine(pcfg, pparams, max_batch=1, max_len=100, decode_block=4)
    first = eng.submit(list(range(200, 290)), max_new=11)   # fills 100
    rid = eng.submit(prompt, max_new=5)
    outs = eng.run_to_completion()
    assert outs[rid] == ref
    assert len(outs[first]) == 11
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(1, 97)), max_new=6)


def test_sampled_streams_equal_jax_engine():
    jcfg, pcfg, jparams, pparams = _setup("gemma-2b")
    kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    jeng = jax_engine.ServingEngine(jcfg, jparams, max_batch=2,
                                    max_len=MAX_LEN, decode_block=2, seed=7)
    jr = [jeng.submit(p, max_new=MAX_NEW, **kw) for p in PROMPTS]
    jouts = jeng.run_to_completion()
    eng = _engine(pcfg, pparams, decode_block=2, seed=7)
    pr = [eng.submit(p, max_new=MAX_NEW, **kw) for p in PROMPTS]
    pouts = eng.run_to_completion()
    assert [pouts[r] for r in pr] == [jouts[r] for r in jr]


def test_kv_engine_refuses_packing_and_speculation():
    _, pcfg, _, pparams = _setup("gemma-2b")
    assert not pt_lm.supports_prompt_packing(pcfg)
    with pytest.raises(ValueError, match="prompt_chunk"):
        _engine(pcfg, pparams, prompt_chunk=4)
    with pytest.raises(ValueError, match="speculative"):
        _engine(pcfg, pparams, speculative="ngram")
    state = pt_lm.init_slot_state(pcfg, 2, MAX_LEN, device="cpu")
    with pytest.raises(NotImplementedError, match="prompt_chunk"):
        pt_lm.superstep(pparams, pcfg, state, 2, prompt_chunk=4)
    one = torch.ones((2, 3), dtype=torch.int32)
    valid = torch.full((2,), 3, dtype=torch.int32)
    for fn in (pt_lm.decode_chunk, pt_lm.decode_verify):
        with pytest.raises(NotImplementedError, match="minrnn"):
            fn(pparams, pcfg, one, valid, state["cache"])
    _, cache = pt_lm.prefill(pparams, pcfg, one, MAX_LEN)
    with pytest.raises(NotImplementedError, match="resume"):
        pt_lm.prefill(pparams, pcfg, one, MAX_LEN, cache=cache)


def test_autotune_refuses_the_attention_trunk():
    from repro_torch.serving import autotune
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        autotune.sweep("gemma-2b", smoke=True, device="cpu", points=1)


def test_slot_state_carries_kv_and_rearm_leaves_it():
    _, pcfg, _, _ = _setup("gemma-2b")
    state = pt_lm.init_slot_state(pcfg, 3, 16, device="cpu")
    cache = state["cache"]
    assert tuple(cache["k"].shape) == (2, 3, 16, 1, 32)
    cache = dict(cache, k=torch.randn(cache["k"].shape),
                 pos=torch.tensor([4, 5, 6], dtype=torch.int32))
    out = pt_lm._reset_slot_rows(cache, torch.tensor([True, False, True]))
    assert out["k"] is cache["k"] and out["v"] is cache["v"]
    assert out["pos"].tolist() == [0, 5, 0]


def _trace(n, seed):
    rng = np.random.default_rng(seed)
    return sorted(
        (dict(arrival=int(rng.integers(0, 3 * n)),
              prompt=[int(x) for x in rng.integers(1, 1000,
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


def test_kv_engine_kill_restore_bit_identical(tmp_path):
    """Snapshots carry the KV cache: a killed gemma-2b engine restored
    from its newest snapshot and the journal's tail finishes with the
    uninterrupted run's streams and round clock."""
    _, pcfg, _, pparams = _setup("gemma-2b")
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
    for k in ("k", "v"):
        leaf = arrays[ckpt.SEP.join(("state", "cache", k))]
        assert torch.equal(leaf, rec.state["cache"][k])


def test_kv_engine_under_faults_keeps_its_streams():
    """Dropped uploads, stragglers and a NaN poured into the recurrent
    state (a KV cache has none, as in the reference: nothing to poison)
    leave every greedy stream equal to generate_one's."""
    _, pcfg, _, pparams = _setup("gemma-2b")
    inj = FaultInjector(seed=3, drop_rate=0.3, nan_at=((2, 0), (3, 1)))
    eng = _engine(pcfg, pparams, decode_block=2, faults=inj)
    rids = [eng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    outs = eng.run_to_completion()
    assert tuple(tuple(outs[r]) for r in rids) == _refs("gemma-2b")
    assert inj.counts()["drop_upload"] > 0


def test_serve_and_train_launchers_run_gemma_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve, train
    serve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                "--prompts", "To be", "Hi", "--max-new", "4",
                "--decode-block", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "kernel tier: unfused" in out and "superstep K=2" in out
    serve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                "--prompts", "To be", "--max-new", "3", "--prefill",
                "--max-len", "32"])
    assert "prefill:" in capsys.readouterr().out
    for arch in ("gemma-2b", "gemma-2b-mingru"):
        report = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "16",
                             "--ckpt-dir", str(tmp_path / arch),
                             "--log-every", "1"])
        assert report.failures_recovered == 0
        assert "step 2:" in capsys.readouterr().out
