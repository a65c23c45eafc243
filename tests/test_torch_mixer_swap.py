"""Port parity for the paper's swap of attention for a minRNN cell inside
the MoE and hybrid trunks: ``archs.get(name).replace(seq_mixer=...)`` of
deepseek-moe-16b (minGRU and minLSTM) and deepseek-v3-671b (minGRU),
trained, prefilled and served, and zamba2-2.7b with a minGRU shared
block, and zamba2-2.7b with an MLA shared block (the widths of
deepseek-v3-671b's smoke config), trained (the reference cannot serve
them: its hybrid decode and prefill read the shared block's KV cache).
With ``minrnn=None`` the mixer is the cell in log mode at expansion 1.0
and its down projection, as the reference's ``_mixer_init`` reads it.

Smoke sizes, fp32 on the CPU, one seeded set of weights in both packages
(the port's init, carried to the reference by ``bridge.params_to_numpy``;
the reference's own init has the same tree, leaf for leaf in shape) and
the same numpy-seeded inputs through both packages.  Logits, aux losses
and caches at atol = rtol = 1e-5; gradients at rtol 1e-4 / atol 3e-5;
the 5-step trajectory's metrics at rtol 1e-4 and its params at rtol 1e-3
/ atol 1e-4 (``tests/test_torch_moe.py``'s).  Greedy engine streams
equal the JAX ``generate_one`` token for token at K 1 and 4, seeded
sampled streams the JAX engine's.

The reference's functions are jitted with LLVM's optimisation level 0
(``_jit``): the same HLO and arithmetic, compiled in about half the
time, which is most of this file's cost; what only has to raise is
traced (``jax.eval_shape``), not run.
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
from repro_torch import bridge, tree
from repro_torch.configs import archs as pt_archs
from repro_torch.models import lm as pt_lm
from repro_torch.models import moe as pt_moe
from repro_torch.serving import engine as pt_engine
from repro_torch.serving import recovery
from repro_torch.serving.faults import FaultInjector
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as pt_opt
from repro_torch.training import train_step as pt_ts

TOL = 1e-5
MAX_LEN = 32
PROMPTS = ([1, 2, 3, 4], [5, 6, 7], [2, 4, 6, 8, 10, 1])
MAX_NEW = 5
# an MLA shared block at the MLA smoke config's widths
MLA = ("mla_q_lora", "mla_kv_lora", "mla_rope_dim", "mla_qk_nope_dim",
       "mla_v_dim")
# the swapped MoE trunks, served; the swapped hybrids, trained only
SERVED = {"moe16b-mingru": ("deepseek-moe-16b", "mingru"),
          "moe16b-minlstm": ("deepseek-moe-16b", "minlstm"),
          "v3-mingru": ("deepseek-v3-671b", "mingru")}
HYBRIDS = {"zamba2-mingru": ("zamba2-2.7b", "mingru"),
           "zamba2-mla": ("zamba2-2.7b", "mla")}
CASES = dict(SERVED, **HYBRIDS)
# 22 tokens x top-2 over 8 experts at capacity factor 0.5: 2 rows an
# expert, so assignments drop
DROP_CF = 0.5
_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _jit(fn, *args):
    """``fn`` jitted for ``args``' shapes and compiled at LLVM level 0; the
    compiled function takes arrays of those shapes."""
    return jax.jit(fn).lower(*args).compile(compiler_options=_FAST_COMPILE)


def _swap(archs, arch, mixer):
    cfg = archs.smoke(arch)
    if mixer != "mla":
        return cfg.replace(seq_mixer=mixer)
    v3 = archs.smoke("deepseek-v3-671b")
    return cfg.replace(attn_kind="mla",
                       **{f: getattr(v3, f) for f in MLA})


@functools.lru_cache(maxsize=None)
def _setup(case):
    jcfg, pcfg = (_swap(a, *CASES[case]) for a in (jax_archs, pt_archs))
    pparams = pt_lm.init_params(torch.Generator().manual_seed(0), pcfg,
                                device="cpu")
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(pparams))
    return jcfg, pcfg, jparams, pparams


@functools.lru_cache(maxsize=None)
def _refs(case):
    jcfg, _, jparams, _ = _setup(case)
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


def _with_cf(cfg, cf):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


# ---------------------------------------------------------------------------
# Config and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_config_tier_and_bridged_tree(case):
    """The swapped config equals the reference's field for field; the
    reference's own init has the port's tree, leaf for leaf in shape
    (``mixer: {rnn, down}`` beside ``moe`` in the MoE layers, under
    ``shared_attn`` in the hybrid; the MLA projections there), the cell's
    gates Dx = Dh = d_model (expansion 1.0, no minrnn config); the bridge
    carries the weights across and back bit for bit."""
    jcfg, pcfg, jparams, pparams = _setup(case)
    for f in dataclasses.fields(pcfg):
        j, p = getattr(jcfg, f.name), getattr(pcfg, f.name)
        if dataclasses.is_dataclass(p):
            j, p = dataclasses.asdict(j), dataclasses.asdict(p)
        assert j == p, f.name
    assert pcfg.minrnn is None
    own = jax.eval_shape(lambda k: jax_lm.init_params(k, jcfg),
                         jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in _flat(own)} == \
        {k: tuple(v.shape) for k, v in _flat(pparams)}
    back = dict(_flat(bridge.params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")))
    assert all(torch.equal(v, back[k]) for k, v in _flat(pparams))
    d = pcfg.d_model
    if case in SERVED:
        assert pt_lm.kernel_tier(pcfg) == "cell-fused"
        mixer = pparams["layers"]["blocks"]["mixer"]
        assert "moe" in pparams["layers"]["blocks"]
        assert "mlp" in pparams["layers"]["dense_blocks"]
    else:
        mixer = pparams["layers"]["shared_attn"]["mixer"]
    if pcfg.seq_mixer == "native":
        assert pcfg.attn_kind == "mla" and "rnn" not in mixer
        return
    assert set(mixer) == {"rnn", "down"}
    assert tuple(mixer["rnn"]["wh"]["kernel"].shape)[-2:] == (d, d)
    layers = pt_lm.bind_layers(pparams, pcfg)
    assert all(ops_ is None for _, ops_ in layers)     # no kernel on CPU


# ---------------------------------------------------------------------------
# Training: logits, loss, gradients, a trajectory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_forward_logits_and_aux_match_jax(case):
    jcfg, pcfg, jparams, pparams = _setup(case)
    toks = _tokens(1, (2, 13))
    jt = jnp.asarray(toks)
    want, jaux = _jit(lambda p, t: jax_lm.forward(p, jcfg, t), jparams,
                      jt)(jparams, jt)
    got, aux = pt_lm.forward(pparams, pcfg, torch.from_numpy(toks))
    _close(want, got)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=0)
    assert (float(aux) > 0) == (case in SERVED)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(case):
    """The reference's ``value_and_grad`` of its loss, jitted once for the
    loss test and the trajectory (its train step is this and
    ``optimizer.apply``: ``repro/training/train_step.py``)."""
    jcfg, _, jparams, _ = _setup(case)
    return _jit(jax.value_and_grad(lambda p, b: jax_lm.loss_fn(p, jcfg, b),
                                   has_aux=True), jparams, _batch(0))


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_jax(case):
    """The loss holds the router's aux term (``moe_aux``) in the MoE
    trunks; the gradients of every leaf, the cell's gates and ``down``
    among them."""
    jcfg, pcfg, jparams, pparams = _setup(case)
    batch = _batch(0)
    (jl, jm), jg = _jax_grad_fn(case)(jparams, batch)
    pp = tree.tree_map(torch.clone, pparams)
    (pl, pm), pg = pt_ts.value_and_grad(pt_ts.make_loss_fn(pcfg), pp,
                                        pt_ts.batch_to(batch, "cpu"))
    assert set(pm) == set(jm)
    for k in pm:
        if k != "ntokens":
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=TOL, err_msg=k)
    if case in SERVED:
        np.testing.assert_allclose(
            float(pl), float(pm["nll"]) + pcfg.moe.router_aux_weight
            * float(pm["moe_aux"]), rtol=TOL)
    _trees_close(jg, pg, rtol=1e-4, atol=3e-5)


@pytest.mark.parametrize("case", [c for c in CASES if c != "zamba2-mla"])
def test_five_step_trajectory_matches_jax(case):
    """The port's ``make_train_step`` against the reference's step: its
    loss gradients and AdamW update (``optimizer.apply``), jitted.  The
    MLA shared block is held at one step (``test_loss_and_grads_...``):
    its trunk's update is the minGRU hybrid's."""
    jcfg, pcfg, jparams, pparams = _setup(case)
    pparams = tree.tree_map(torch.clone, pparams)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    jopt = jax_opt.AdamWConfig(**ocfg)
    pstep = pt_ts.make_train_step(pcfg, pt_opt.AdamWConfig(**ocfg))
    jstate = jax_opt.init(jopt, jparams)
    japply = _jit(functools.partial(jax_opt.apply, jopt), jstate, jparams,
                  jparams)
    pstate = pt_opt.init(pt_opt.AdamWConfig(**ocfg), pparams)
    losses = []
    keys = ("loss", "nll", "grad_norm", "lr") + (
        ("moe_aux",) if case in SERVED else ())
    for step in range(5):
        batch = _batch(step)
        (_, jm), jg = _jax_grad_fn(case)(jparams, batch)
        jparams, jstate, om = japply(jstate, jparams, jg)
        jm = dict(jm, **om)
        pparams, pstate, pm = pstep(pparams, pstate, batch)
        for k in keys:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} @ {step}")
        losses.append(float(pm["loss"]))
    assert losses[-1] < losses[0]
    _trees_close(jparams, pparams, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# Decode and prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SERVED)
def test_prefill_with_lengths_then_decode_matches_jax(case):
    """A right-padded prefill: the logits at each row's last position and
    the cell state ``h`` gathered there, then 3 decode steps."""
    jcfg, pcfg, jparams, pparams = _setup(case)
    toks = _tokens(2, (3, 11))
    lengths = np.array([11, 4, 1], np.int32)
    args = (jparams, jnp.asarray(toks), jnp.asarray(lengths))
    jl, jc = _jit(lambda p, t, n: jax_lm.prefill(p, jcfg, t, 16, lengths=n),
                  *args)(*args)
    pl, pc = pt_lm.prefill(pparams, pcfg, torch.from_numpy(toks), 16,
                           lengths=torch.from_numpy(lengths))
    assert set(pc) == set(jc) == {"pos", "h"}
    assert tuple(pc["h"].shape) == (pcfg.n_layers, 3, pcfg.d_model)
    _close(jl, pl)
    _close(jc["h"], pc["h"])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), pc["pos"].numpy())
    step = _jit(lambda c, t: jax_lm.decode_step(jparams, jcfg, t, c), jc,
                jnp.zeros((3,), jnp.int32))
    for i in range(3):
        t = _tokens(10 + i, (3,))
        jl, jc = step(jc, jnp.asarray(t))
        pl, pc = pt_lm.decode_step(pparams, pcfg, torch.from_numpy(t), pc)
        _close(jl, pl)
    _close(jc["h"], pc["h"])


@pytest.mark.parametrize("case", ["moe16b-mingru", "v3-mingru"])
def test_dropped_assignments_are_counted_and_match_jax(case):
    """At capacity factor 0.5 assignments drop: ``count_drops`` reports
    them, and the logits still equal the reference's."""
    jcfg, pcfg, jparams, pparams = _setup(case)
    jcfg, pcfg = _with_cf(jcfg, DROP_CF), _with_cf(pcfg, DROP_CF)
    toks = _tokens(4, (2, 11))
    want, _ = _jit(lambda p, t: jax_lm.forward(p, jcfg, t), jparams,
                   jnp.asarray(toks))(jparams, jnp.asarray(toks))
    with pt_moe.count_drops() as drops:
        got, _ = pt_lm.forward(pparams, pcfg, torch.from_numpy(toks))
    _close(want, got)
    n_moe = pcfg.n_layers - pcfg.moe.first_dense_layers
    assert len(drops) == n_moe
    assert all(n == 22 * pcfg.moe.top_k for _, n in drops)
    assert sum(int(d) for d, _ in drops) > 0


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _engine(pcfg, pparams, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", MAX_LEN)
    return pt_engine.ServingEngine(pcfg, pparams, device="cpu", **kw)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("case", SERVED)
def test_engine_greedy_streams_equal_jax_generate_one(case, k):
    _, pcfg, _, pparams = _setup(case)
    eng = _engine(pcfg, pparams, decode_block=k)
    assert eng.kernel_tier == "cell-fused"
    rids = [eng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    outs = eng.run_to_completion()
    assert tuple(tuple(outs[r]) for r in rids) == _refs(case)
    assert eng.stats.shard_identities_ok()
    if k == 1:
        assert tuple(tuple(pt_engine.generate_one(
            pcfg, pparams, p, max_new=MAX_NEW, max_len=MAX_LEN,
            device="cpu")) for p in PROMPTS) == _refs(case)


@pytest.mark.parametrize("case", SERVED)
def test_sampled_streams_equal_jax_engine(case):
    jcfg, pcfg, jparams, pparams = _setup(case)
    kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    jeng = jax_engine.ServingEngine(jcfg, jparams, max_batch=2,
                                    max_len=MAX_LEN, decode_block=2, seed=7)
    jr = [jeng.submit(p, max_new=MAX_NEW, **kw) for p in PROMPTS]
    jouts = jeng.run_to_completion()
    eng = _engine(pcfg, pparams, decode_block=2, seed=7)
    pr = [eng.submit(p, max_new=MAX_NEW, **kw) for p in PROMPTS]
    pouts = eng.run_to_completion()
    assert [pouts[r] for r in pr] == [jouts[r] for r in jr]


def test_packing_and_speculation_stay_refused():
    """As in the reference: the attention trunk's state is no whole
    recurrence, so prompt packing and speculation refuse."""
    jcfg, pcfg, _, pparams = _setup("moe16b-mingru")
    assert not pt_lm.supports_prompt_packing(pcfg)
    assert not jax_lm.supports_prompt_packing(jcfg)
    with pytest.raises(ValueError, match="prompt_chunk"):
        _engine(pcfg, pparams, prompt_chunk=4)
    with pytest.raises(ValueError, match="speculative"):
        _engine(pcfg, pparams, speculative="ngram")


def test_engine_kill_restore_and_faults_carry_the_cell_state(tmp_path):
    """Snapshots carry the cell state ``h``: an engine killed after 4
    decode steps and restored finishes with the uninterrupted run's
    streams; NaN poured into two slots' ``h`` is quarantined and retried,
    and every stream still equals generate_one's."""
    case = "moe16b-mingru"
    _, pcfg, _, pparams = _setup(case)
    eng = _engine(pcfg, pparams, decode_block=2, recover_dir=str(tmp_path),
                  snapshot_every=2)
    rids = [eng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    while eng.stats.decode_steps < 4:
        eng.step(2)
    assert len(eng.finished) < len(PROMPTS)
    eng.journal.close()
    del eng
    rec = pt_engine.ServingEngine.restore(str(tmp_path), pcfg, pparams,
                                          device="cpu")
    assert rec.recovery_report["snapshot_round"] is not None
    got = rec.run_to_completion()
    assert tuple(tuple(got[r]) for r in rids) == _refs(case)
    arrays, _ = recovery.snapshot_engine(rec)
    assert torch.equal(arrays[ckpt.SEP.join(("state", "cache", "h"))],
                       rec.state["cache"]["h"])
    inj = FaultInjector(seed=3, drop_rate=0.3, nan_at=((2, 0), (3, 1)))
    eng = _engine(pcfg, pparams, decode_block=2, faults=inj)
    rids = [eng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    outs = eng.run_to_completion()
    assert tuple(tuple(outs[r]) for r in rids) == _refs(case)
    assert inj.counts()["drop_upload"] > 0
    assert eng.stats.quarantined > 0


# ---------------------------------------------------------------------------
# The hybrid with a minGRU or MLA shared block: trained, not served
# ---------------------------------------------------------------------------

def test_hybrid_serving_is_refused_in_both_packages():
    """The reference's hybrid decode and prefill hand the shared block
    its ``k`` / ``v`` cache and fail on a minRNN or MLA shared block
    (KeyError, while tracing); the port refuses every serving entry point
    with a message naming that gap."""
    for case in HYBRIDS:
        jcfg, pcfg, jparams, pparams = _setup(case)
        tok = jnp.zeros((2,), jnp.int32)
        with pytest.raises(KeyError):
            jax.eval_shape(lambda: jax_lm.decode_step(
                jparams, jcfg, tok, jax_lm.init_cache(jcfg, 2, 8)))
        with pytest.raises(KeyError):
            jax.eval_shape(lambda: jax_lm.prefill(
                jparams, jcfg, jnp.ones((2, 3), jnp.int32), 8))
        one = torch.ones((2, 3), dtype=torch.int32)
        calls = (lambda: pt_lm.init_cache(pcfg, 2, 8, device="cpu"),
                 lambda: pt_lm.decode_step(pparams, pcfg, one[:, 0], {}),
                 lambda: pt_lm.prefill(pparams, pcfg, one, 8),
                 lambda: pt_lm.init_slot_state(pcfg, 2, 8, device="cpu"),
                 lambda: _engine(pcfg, pparams))
        for call in calls:
            with pytest.raises(NotImplementedError,
                               match=r"trains only.*lm\.py:1220 and :1437"):
                call()
