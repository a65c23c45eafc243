"""Port parity for the mixture-of-experts trunk: the MoE layer
(``models/moe.py``) and deepseek-moe-16b (smoke: 1 dense + 2 MoE layers,
d64, 4 heads of 16, 8 experts of 32 with top-2 and 2 shared experts of
total width 64, capacity factor 16, vocab 512, fp32), trained, prefilled
and served.

The JAX params are bridged into the port and the same numpy-seeded inputs
go through both packages.  Outputs, aux losses, logits, caches and losses
at atol = rtol = 1e-5 (the same fp32 arithmetic, sums in another order);
gradients and the 5-step trajectory at the tolerances of
``test_torch_training.py`` (grads rtol 1e-4 / atol 1e-5, here 2e-5 where
the router's softmax and renormalisation stack another few roundings;
per-step metrics rtol 1e-4; final params rtol 1e-3 / atol 1e-4).  The
layer is held twice: at the smoke capacity (no assignment drops) and at
capacity factor 0.5, where 28 of the 44 assignments of the test's 22
tokens drop (the count taken from the reference's own routing).  Greedy
streams must equal the JAX ``generate_one`` token for token, seeded
sampled streams the JAX engine's.
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
from repro.models import moe as jax_moe
from repro.serving import engine as jax_engine
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro_torch import bridge, tree
from repro_torch.configs import archs as pt_archs
from repro_torch.models import lm as pt_lm
from repro_torch.models import moe as pt_moe
from repro_torch.serving import engine as pt_engine
from repro_torch.training import optimizer as pt_opt
from repro_torch.training import train_step as pt_ts

ARCH = "deepseek-moe-16b"
TOL = 1e-5
MAX_LEN = 64
# tests/test_serving.py's prompts for the engine against generate_one
PROMPTS = ([1, 2, 3, 4], [5, 6, 7], [2, 4, 6, 8, 10, 1])
MAX_NEW = 6
# the drop case: 22 tokens x top-2 over 8 experts, 2 rows an expert
DROP_CF = 0.5
DROP_COUNT = 28


def _with_cf(cfg, cf):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


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
        if f.name != "moe":
            assert getattr(j, f.name) == getattr(p, f.name), (get, f.name)
    assert dataclasses.asdict(j.moe) == dataclasses.asdict(p.moe)
    assert (j.head_dim_, j.padded_vocab) == (p.head_dim_, p.padded_vocab)
    if get == "get":
        m = p.moe
        assert (p.n_layers, m.first_dense_layers, p.d_model, p.d_ff,
                m.n_experts, m.top_k, m.d_expert, m.n_shared, m.d_shared,
                m.capacity_factor, p.n_heads, p.head_dim_, p.vocab_size,
                p.tie_embeddings, p.compute_dtype) == \
            (28, 1, 2048, 10944, 64, 6, 1408, 2, 2816, 1.25, 16, 128,
             102400, False, "bfloat16")


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
    assert got[("layers", "dense_blocks", "mlp", "up", "kernel")][0] == (
        1, 64, 128)
    assert got[("layers", "blocks", "moe", "gate_w", "kernel")][0] == (
        2, 8, 64, 32)
    assert got[("layers", "blocks", "moe", "router", "kernel")][1] == \
        torch.float32
    assert pt_lm.kernel_tier(pcfg) == "unfused"
    layers = pt_lm.bind_layers(own, pcfg)
    assert ["moe" in p for p, _ in layers] == [False, True, True]
    assert all(b is None for _, b in layers)


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

def _jax_drops(jcfg, jlayer, x):
    """Dropped assignments by the reference's own router and top-k,
    positions counted token-major as its dispatch counts them."""
    m = jcfg.moe
    n = x.shape[0] * x.shape[1]
    logits = jnp.asarray(x.reshape(n, -1)) @ jlayer["router"]["kernel"]
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    cap = max(1, int(m.capacity_factor * n * m.top_k / m.n_experts))
    load, drops = np.zeros(m.n_experts, int), 0
    for e in np.asarray(idx).reshape(-1):          # token-major
        drops += load[e] >= cap
        load[e] += 1
    return int(drops)


@pytest.mark.parametrize("cf", [None, DROP_CF])
def test_moe_apply_output_aux_and_grads_match_jax(cf):
    jcfg, pcfg, jparams, pparams = _setup()
    if cf is not None:
        jcfg, pcfg = _with_cf(jcfg, cf), _with_cf(pcfg, cf)
    jlayer = jax.tree.map(lambda a: a[0], jparams["layers"]["blocks"]["moe"])
    player = tree.tree_map(lambda a: a[0].clone().requires_grad_(True),
                           pparams["layers"]["blocks"]["moe"])
    x = np.random.default_rng(5).standard_normal((2, 11, 64)).astype(
        np.float32)
    ct = np.random.default_rng(6).standard_normal((2, 11, 64)).astype(
        np.float32)

    def jloss(p, x_):
        y, aux = jax_moe.moe_apply(p, jcfg, x_, activation="silu")
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jlayer, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    with pt_moe.count_drops() as drops:
        py, paux = pt_moe.moe_apply(player, pcfg, xt, activation="silu")
    (py * torch.from_numpy(ct)).sum().add(paux).backward()
    _close(jy, py)
    np.testing.assert_allclose(float(paux.detach()), float(jaux), rtol=TOL)
    want = _jax_drops(jcfg, jlayer, x)
    assert [int(d) for d, _ in drops] == [want]
    assert drops[0][1] == 44
    assert want == (0 if cf is None else DROP_COUNT)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=2e-5)
    _trees_close(jgp, {k: tree.tree_map(lambda a: a.grad, v)
                       for k, v in player.items()}, rtol=1e-4, atol=2e-5)


def test_moe_dispatch_is_deterministic_and_tiles_keep_the_values():
    """Two calls on one input are bit-equal; the decode step's tiles of 8
    rows (``rows=8``: router, experts over the capacity axis, shared
    experts) give the untiled values to fp32 rounding, at 11 tokens (a
    padded second tile) and with drops."""
    _, pcfg, _, pparams = _setup()
    layer = tree.tree_map(lambda a: a[1], pparams["layers"]["blocks"]["moe"])
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (11, 1, 64)).astype(np.float32))
    for cfg in (pcfg, _with_cf(pcfg, DROP_CF)):
        y1, a1 = pt_moe.moe_apply(layer, cfg, x)
        y2, a2 = pt_moe.moe_apply(layer, cfg, x)
        assert torch.equal(y1, y2) and torch.equal(a1, a2)
        yt, at = pt_moe.moe_apply(layer, cfg, x, rows=8)
        torch.testing.assert_close(yt, y1, rtol=TOL, atol=TOL)
        assert abs(float(at - a1)) < TOL


def test_routing_log_and_forced_routing():
    """``routing_log`` records each call's own top-k experts; the
    sequential steps held to the prefill's logged routing
    (``forced_routing``) give the free steps' logits (fp32: no choice
    apart), and a routing forced elsewhere changes them while the log
    keeps the calls' own choices; ``count_drops`` sees no drop at the
    smoke capacity."""
    _, pcfg, _, pparams = _setup()
    toks = torch.from_numpy(_tokens(4, (3, 7)))
    with pt_moe.routing_log() as log:
        lp, _ = pt_lm.prefill(pparams, pcfg, toks, 16)
    assert [tuple(r.shape) for r in log] == [(21, 2), (21, 2)]
    pre = [r.reshape(3, 7, 2) for r in log]

    def steps(force):
        cache = pt_lm.init_cache(pcfg, 3, 16, device="cpu")
        with pt_moe.forced_routing(force), pt_moe.count_drops() as drops, \
                pt_moe.routing_log() as own:
            for t in range(7):
                out, cache = pt_lm.decode_step(pparams, pcfg, toks[:, t],
                                               cache)
        assert len(drops) == 14 and all(int(d) == 0 for d, _ in drops)
        return out, own

    held, own = steps(lambda i: pre[i % 2][:, i // 2])
    _close(lp.numpy(), held)
    assert all(torch.equal(own[i], pre[i % 2][:, i // 2])
               for i in range(14))
    cache = pt_lm.init_cache(pcfg, 3, 16, device="cpu")
    for t in range(7):
        free, cache = pt_lm.decode_step(pparams, pcfg, toks[:, t], cache)
    assert torch.equal(held, free)
    other, own = steps(lambda i: (pre[i % 2][:, i // 2] + 1) % 8)
    assert (other - free).abs().max() > 1e-3
    assert torch.equal(own[0], pre[0][:, 0])


def test_moe_mesh_path_names_the_roadmap():
    """The mesh path is ported (ROADMAP.md queue 1, item 6): on a 1x1
    ``RankMesh``, built in this process with no world, as the ``mesh=``
    argument or the context's mesh, ``moe_apply`` is the no-mesh path bit
    for bit, output, aux and gradients (expert parallelism over worlds:
    ``test_torch_expert_parallel.py``)."""
    from repro_torch.distributed import context as mesh_ctx
    from repro_torch.distributed import serve_mesh
    _, pcfg, _, pparams = _setup()
    layer = tree.tree_map(lambda a: a[0].clone(),
                          pparams["layers"]["blocks"]["moe"])
    mesh = serve_mesh.MeshPlan(1, 1).build()
    assert mesh.model_group is None and mesh.data_group is None
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 11, 64)
                         .astype(np.float32))

    def run(**kw):
        for leaf in tree.leaves(layer):
            leaf.grad = None
            leaf.requires_grad_(True)
        xg = x.clone().requires_grad_(True)
        y, aux = pt_moe.moe_apply(layer, pcfg, xg, **kw)
        (y.square().sum() + aux).backward()
        return [y, aux, xg.grad] + [leaf.grad for leaf in tree.leaves(layer)]

    plain = run()
    with mesh_ctx.use_mesh(mesh):
        in_context = run()
    for got in (run(mesh=mesh), in_context):
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


# ---------------------------------------------------------------------------
# The trunk: logits, loss, gradients, training
# ---------------------------------------------------------------------------

def test_forward_logits_and_aux_match_jax():
    jcfg, pcfg, jparams, pparams = _setup()
    toks = _tokens(1, (2, 13))
    want, jaux = jax.jit(lambda p, t: jax_lm.forward(p, jcfg, t))(
        jparams, jnp.asarray(toks))
    got, aux = pt_lm.forward(pparams, pcfg, torch.from_numpy(toks))
    _close(want, got)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL)
    assert float(aux) > 0


def test_loss_with_moe_aux_and_grads_match_jax():
    jcfg, pcfg, jparams, pparams = _setup()
    batch = _batch(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm.loss_fn(p, jcfg, b), has_aux=True))(
        jparams, batch)
    pp = tree.tree_map(torch.clone, pparams)
    (pl, pm), pg = pt_ts.value_and_grad(pt_ts.make_loss_fn(pcfg), pp,
                                        pt_ts.batch_to(batch, "cpu"))
    assert set(pm) == set(jm)
    for k in ("loss", "nll", "moe_aux"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=TOL,
                                   err_msg=k)
    np.testing.assert_allclose(
        float(pl), float(pm["nll"]) + 0.01 * float(pm["moe_aux"]), rtol=TOL)
    _trees_close(jg, pg, rtol=1e-4, atol=2e-5)


def test_remat_full_matches_no_remat():
    _, pcfg, _, pparams = _setup()
    batch = pt_ts.batch_to(_batch(1), "cpu")
    outs = []
    for remat in ("none", "full"):
        pp = tree.tree_map(torch.clone, pparams)
        outs.append(pt_ts.value_and_grad(
            pt_ts.make_loss_fn(pcfg.replace(remat=remat)), pp, batch))
    (l0, m0), g0 = outs[0]
    (l1, m1), g1 = outs[1]
    assert float(l0) == float(l1) and float(m0["moe_aux"]) == \
        float(m1["moe_aux"])
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
        for k in ("loss", "nll", "moe_aux", "grad_norm", "lr"):
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
    assert set(pc) == set(jc) == {"pos", "k", "v"}
    for k in pc:
        assert tuple(pc[k].shape) == jc[k].shape, k
    assert pc["k"].shape[0] == 3                  # dense + MoE layers
    step = jax.jit(lambda c, t: jax_lm.decode_step(jparams, jcfg, t, c))
    for i in range(4):
        t = _tokens(10 + i, (3,))
        jl, jc = step(jc, jnp.asarray(t))
        pl, pc = pt_lm.decode_step(pparams, pcfg, torch.from_numpy(t), pc)
        _close(jl, pl)
    for k in ("k", "v"):
        _close(jc[k], pc[k])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), pc["pos"].numpy())


def test_decode_row_is_independent_of_batch():
    """A row stepped in a batch of 11 (two tiles of 8 rows, the second
    padded; the MoE routes all 11 together) equals the row stepped alone,
    bit for bit, at the smoke capacity (no drops)."""
    _, pcfg, _, pparams = _setup()
    toks = torch.from_numpy(_tokens(3, (11, 4)))
    cb = pt_lm.init_cache(pcfg, 11, MAX_LEN, device="cpu")
    c1 = pt_lm.init_cache(pcfg, 1, MAX_LEN, device="cpu")
    for t in range(toks.shape[1]):
        lb, cb = pt_lm.decode_step(pparams, pcfg, toks[:, t], cb)
        l1, c1 = pt_lm.decode_step(pparams, pcfg, toks[9:10, t], c1)
        assert torch.equal(lb[9:10], l1), t
    for k in ("k", "v"):
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
    assert set(pc) == set(jc) == {"pos", "k", "v"}
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
    _, cache = pt_lm.prefill(pparams, pcfg, one, MAX_LEN)
    with pytest.raises(NotImplementedError, match="resume"):
        pt_lm.prefill(pparams, pcfg, one, MAX_LEN, cache=cache)
    from repro_torch.serving import autotune
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        autotune.sweep(ARCH, smoke=True, device="cpu", points=1)


def test_serve_and_train_launchers_run_deepseek_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve, train
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--prompts", "To be", "Hi", "--max-new", "4",
                "--decode-block", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "kernel tier: unfused" in out and "superstep K=2" in out
    report = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "16",
                         "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    assert report.failures_recovered == 0
    out = capsys.readouterr().out
    assert "step 2:" in out and "moe_aux=" in out
