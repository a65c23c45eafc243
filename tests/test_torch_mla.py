"""Port parity for MLA (``models/attention.py``'s ``mla_*``) and
deepseek-v3-671b (smoke: 1 dense + 2 MoE layers, d64, 4 heads, q LoRA
32, kv LoRA 16, rope dim 8, nope and v dims 16, 8 experts of 32 with
top-2 and a shared expert of 32, capacity factor 16, vocab 512, fp32),
trained, prefilled and served.

The JAX params are bridged into the port and the same numpy-seeded inputs
go through both packages.  Outputs, logits and caches at atol = rtol =
1e-5 (the same fp32 arithmetic, sums in another order; the decode
attends in the latent space in both, the port in fp32 tiles of 8 rows);
gradients at rtol 1e-4 / atol 2e-5 and the 5-step trajectory at the
tolerances of ``tests/test_torch_moe.py``.  Greedy engine streams must
equal the JAX ``generate_one`` token for token.  Also the registry: every
architecture of the reference's, full and smoke, field for field.
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
from repro.models import attention as jax_attn
from repro.models import lm as jax_lm
from repro.serving import engine as jax_engine
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro_torch import bridge, tree
from repro_torch.configs import archs as pt_archs
from repro_torch.models import attention as pt_attn
from repro_torch.models import lm as pt_lm
from repro_torch.serving import engine as pt_engine
from repro_torch.serving import recovery
from repro_torch.serving.faults import FaultInjector
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as pt_opt
from repro_torch.training import train_step as pt_ts

ARCH = "deepseek-v3-671b"
TOL = 1e-5
MAX_LEN = 64
# tests/test_serving.py's prompts for the engine against generate_one
PROMPTS = ([1, 2, 3, 4], [5, 6, 7], [2, 4, 6, 8, 10, 1])
MAX_NEW = 6
# tests/test_serving.py's padding-invariance prompts
PAD_PROMPTS = ([1, 2, 3, 4], [5, 6, 7], [2, 4, 6, 8, 10, 1, 3, 7, 9])


@functools.lru_cache(maxsize=None)
def _setup(n_layers=None):
    jcfg, pcfg = jax_archs.smoke(ARCH), pt_archs.smoke(ARCH)
    if n_layers is not None:
        jcfg = jcfg.replace(n_layers=n_layers)
        pcfg = pcfg.replace(n_layers=n_layers)
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
# Configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", jax_archs.all_names())
@pytest.mark.parametrize("get", ["get", "smoke"])
def test_registry_holds_every_reference_arch_field_for_field(name, get):
    """Every architecture of the reference's registry is registered here,
    full and smoke, each field the port's config has equal to the
    reference's (sub-configs field for field)."""
    assert set(pt_archs.all_names()) == set(jax_archs.all_names())
    j = getattr(jax_archs, get)(name)
    p = getattr(pt_archs, get)(name)
    for f in dataclasses.fields(p):
        a, b = getattr(j, f.name), getattr(p, f.name)
        if dataclasses.is_dataclass(b):
            assert {g.name: getattr(a, g.name)
                    for g in dataclasses.fields(b)} == \
                dataclasses.asdict(b), (name, get, f.name)
        else:
            assert a == b, (name, get, f.name)
    assert j.padded_vocab == p.padded_vocab
    if p.n_heads:
        assert j.head_dim_ == p.head_dim_


def test_full_config_is_the_published_one():
    p = pt_archs.get(ARCH)
    m = p.moe
    assert (p.attn_kind, p.n_layers, m.first_dense_layers, p.d_model,
            p.n_heads, p.mla_q_lora, p.mla_kv_lora, p.mla_rope_dim,
            p.mla_qk_nope_dim, p.mla_v_dim, p.d_ff, m.n_experts, m.top_k,
            m.d_expert, m.n_shared, m.d_shared, m.capacity_factor,
            p.vocab_size, p.tie_embeddings, p.compute_dtype) == \
        ("mla", 61, 3, 7168, 128, 1536, 512, 64, 128, 128, 18432, 256, 8,
         2048, 1, 2048, 1.25, 129280, False, "bfloat16")


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
    mix = ("layers", "blocks", "mixer")
    assert got[mix + ("wq_b", "kernel")][0] == (2, 32, 4 * 24)
    assert got[mix + ("wkv_a", "kernel")][0] == (2, 64, 16 + 8)
    assert got[mix + ("wk_b", "kernel")][0] == (2, 16, 4 * 16)
    assert got[("layers", "dense_blocks", "mixer", "kv_norm", "scale")][0] \
        == (1, 16)
    assert pt_lm.kernel_tier(pcfg) == "unfused"
    layers = pt_lm.bind_layers(own, pcfg)
    assert ["moe" in p for p, _ in layers] == [False, True, True]
    assert all(b is None for _, b in layers)


# ---------------------------------------------------------------------------
# The MLA mixer alone
# ---------------------------------------------------------------------------

def _mixer(layer=0):
    jcfg, pcfg, jparams, pparams = _setup()
    jp = jax.tree.map(lambda a: a[layer], jparams["layers"]["blocks"]["mixer"])
    pp = tree.tree_map(lambda a: a[layer].clone(),
                       pparams["layers"]["blocks"]["mixer"])
    return jcfg, pcfg, jp, pp


def test_mla_apply_and_its_gradient_match_jax():
    jcfg, pcfg, jp, pp = _mixer()
    x = np.random.default_rng(5).standard_normal((2, 11, 64)).astype(
        np.float32)
    ct = np.random.default_rng(6).standard_normal((2, 11, 64)).astype(
        np.float32)
    pos = np.arange(11)[None, :]

    def jloss(p, x_):
        y = jax_attn.mla_apply(p, jcfg, x_, positions=jnp.asarray(pos))
        return jnp.sum(y * ct), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    pp = tree.tree_map(lambda a: a.requires_grad_(True), pp)
    xt = torch.from_numpy(x).requires_grad_(True)
    py = pt_attn.mla_apply(pp, pcfg, xt, positions=torch.from_numpy(pos))
    (py * torch.from_numpy(ct)).sum().backward()
    _close(jy, py)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=2e-5)
    _trees_close(jgp, tree.tree_map(lambda a: a.grad, pp), rtol=1e-4,
                 atol=2e-5)


def test_mla_prefill_then_decode_steps_match_jax():
    """``mla_prefill``'s output and latent caches, then absorbed decode
    steps into a cache of 16 (rows at different positions, one at the
    cache's end and one past it, which writes nothing), against the
    reference's."""
    jcfg, pcfg, jp, pp = _mixer(1)
    x = np.random.default_rng(7).standard_normal((3, 9, 64)).astype(
        np.float32)
    pos = np.arange(9)[None, :]
    jo, jckv, jkr = jax.jit(lambda x_: jax_attn.mla_prefill(
        jp, jcfg, x_, positions=jnp.asarray(pos)))(jnp.asarray(x))
    po, pckv, pkr = pt_attn.mla_prefill(pp, pcfg, torch.from_numpy(x),
                                        positions=torch.from_numpy(pos))
    for a, b in ((jo, po), (jckv, pckv), (jkr, pkr)):
        _close(a, b)
    s = 16
    jc = [jnp.zeros((3, s) + a.shape[2:]).at[:, :9].set(a)
          for a in (jckv, jkr)]
    pc = [torch.zeros((3, s) + tuple(a.shape[2:])) for a in (pckv, pkr)]
    for c, a in zip(pc, (pckv, pkr)):
        c[:, :9] = a
    p_now = np.array([9, 15, 16], np.int32)
    jstep = jax.jit(lambda *a: jax_attn.mla_decode_step(jp, jcfg, *a))
    for i in range(3):
        xt = np.random.default_rng(20 + i).standard_normal((3, 64)).astype(
            np.float32)
        jo, jc0, jc1 = jstep(jnp.asarray(xt), jc[0], jc[1],
                             jnp.asarray(p_now))
        jc = [jc0, jc1]
        po, pc0, pc1 = pt_attn.mla_decode_step(
            pp, pcfg, torch.from_numpy(xt), pc[0], pc[1],
            torch.from_numpy(p_now), rows=pt_attn.DECODE_ROWS)
        assert pc0 is pc[0] and pc1 is pc[1]          # written in place
        _close(jo, po)
        for a, b in zip(jc, pc):
            _close(a, b)
        p_now = p_now + 1


# ---------------------------------------------------------------------------
# The trunk: logits, loss, gradients, remat, training
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


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_and_grads_match_jax(remat):
    """The loss (NLL + the router loss) and every gradient, also under
    ``remat="dots"`` in both packages."""
    jcfg, pcfg, jparams, pparams = _setup()
    jcfg, pcfg = jcfg.replace(remat=remat), pcfg.replace(remat=remat)
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
    _trees_close(jg, pg, rtol=1e-4, atol=2e-5)


def test_remat_full_and_dots_match_no_remat():
    _, pcfg, _, pparams = _setup()
    batch = pt_ts.batch_to(_batch(1), "cpu")
    outs = {}
    for remat in ("none", "full", "dots"):
        pp = tree.tree_map(torch.clone, pparams)
        outs[remat] = pt_ts.value_and_grad(
            pt_ts.make_loss_fn(pcfg.replace(remat=remat)), pp, batch)
    (l0, m0), g0 = outs["none"]
    for remat in ("full", "dots"):
        (l1, m1), g1 = outs[remat]
        assert float(l0) == float(l1) and float(m0["moe_aux"]) == \
            float(m1["moe_aux"]), remat
        for (k, a), (_, b) in zip(_flat(g0), _flat(g1)):
            torch.testing.assert_close(a, b, rtol=0, atol=0,
                                       msg=f"{remat} {k}")


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


def test_empty_moe_stack_matches_jax():
    """n_layers = first_dense_layers: the MoE stack has a leading axis of
    0 in both packages; forward, loss, gradients and an AdamW step (which
    has nothing to update in the empty leaves) as the reference's."""
    jcfg, pcfg, jparams, pparams = _setup(1)
    assert pparams["layers"]["blocks"]["moe"]["gate_w"]["kernel"].shape[0] \
        == 0
    own = pt_lm.init_params(torch.Generator().manual_seed(0), pcfg,
                            device="cpu")
    assert {p: tuple(a.shape) for p, a in tree.leaves_with_path(own)} == \
        {p: tuple(a.shape) for p, a in tree.leaves_with_path(pparams)}
    toks = _tokens(2, (2, 9))
    want, jaux = jax.jit(lambda p, t: jax_lm.forward(p, jcfg, t))(
        jparams, jnp.asarray(toks))
    got, aux = pt_lm.forward(pparams, pcfg, torch.from_numpy(toks))
    _close(want, got)
    assert float(aux) == float(jaux) == 0.0
    batch = _batch(2)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm.loss_fn(p, jcfg, b), has_aux=True))(
        jparams, batch)
    (pl, _), pg = pt_ts.value_and_grad(
        pt_ts.make_loss_fn(pcfg), tree.tree_map(torch.clone, pparams),
        pt_ts.batch_to(batch, "cpu"))
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL)
    _trees_close(jg, pg, rtol=1e-4, atol=2e-5)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    jstep = jax.jit(jax_ts.make_train_step(jcfg,
                                           jax_opt.AdamWConfig(**ocfg)))
    pstep = pt_ts.make_train_step(pcfg, pt_opt.AdamWConfig(**ocfg))
    jp = jax.tree.map(jnp.array, jparams)
    pp = tree.tree_map(torch.clone, pparams)
    jp, _, jm = jstep(jp, jax_opt.init(jax_opt.AdamWConfig(**ocfg), jp),
                      batch)
    pp, _, pm = pstep(pp, pt_opt.init(pt_opt.AdamWConfig(**ocfg), pp),
                      batch)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    _trees_close(jp, pp, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# Decode: the cache, the step, the prefill
# ---------------------------------------------------------------------------

def test_init_cache_and_decode_steps_match_jax():
    jcfg, pcfg, jparams, pparams = _setup()
    jc = jax_lm.init_cache(jcfg, 3, MAX_LEN)
    pc = pt_lm.init_cache(pcfg, 3, MAX_LEN, device="cpu")
    assert set(pc) == set(jc) == {"pos", "ckv", "krope"}
    for k in pc:
        assert tuple(pc[k].shape) == jc[k].shape, k
    assert tuple(pc["ckv"].shape) == (3, 3, MAX_LEN, 16)
    step = jax.jit(lambda c, t: jax_lm.decode_step(jparams, jcfg, t, c))
    for i in range(4):
        t = _tokens(10 + i, (3,))
        jl, jc = step(jc, jnp.asarray(t))
        pl, pc = pt_lm.decode_step(pparams, pcfg, torch.from_numpy(t), pc)
        _close(jl, pl)
    for k in ("ckv", "krope"):
        _close(jc[k], pc[k])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), pc["pos"].numpy())


def test_decode_at_and_past_max_len_matches_jax():
    """Rows stepped to the cache's end and on past it (where the insert
    writes nothing and every position is seen), against the reference's
    clamped one-hot."""
    jcfg, pcfg, jparams, pparams = _setup()
    s = 8
    toks = _tokens(4, (2, s + 2))
    jc = jax_lm.init_cache(jcfg, 2, s)
    pc = pt_lm.init_cache(pcfg, 2, s, device="cpu")
    step = jax.jit(lambda c, t: jax_lm.decode_step(jparams, jcfg, t, c))
    for i in range(s + 2):
        jl, jc = step(jc, jnp.asarray(toks[:, i]))
        pl, pc = pt_lm.decode_step(pparams, pcfg,
                                   torch.from_numpy(toks[:, i]), pc)
        _close(jl, pl)
        assert bool(torch.isfinite(pl).all())
    assert pc["pos"].tolist() == [s + 2, s + 2]
    for k in ("ckv", "krope"):
        _close(jc[k], pc[k])


def test_decode_row_is_independent_of_batch():
    """A row stepped in a batch of 11 (two tiles of 8 rows, the second
    padded; the MoE routes all 11 together) equals the row stepped alone,
    bit for bit (no drops at the smoke capacity)."""
    _, pcfg, _, pparams = _setup()
    toks = torch.from_numpy(_tokens(3, (11, 4)))
    cb = pt_lm.init_cache(pcfg, 11, MAX_LEN, device="cpu")
    c1 = pt_lm.init_cache(pcfg, 1, MAX_LEN, device="cpu")
    for t in range(toks.shape[1]):
        lb, cb = pt_lm.decode_step(pparams, pcfg, toks[:, t], cb)
        l1, c1 = pt_lm.decode_step(pparams, pcfg, toks[9:10, t], c1)
        assert torch.equal(lb[9:10], l1), t
    for k in ("ckv", "krope"):
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
    assert set(pc) == set(jc) == {"pos", "ckv", "krope"}
    _close(jl, pl)
    for k in ("ckv", "krope"):
        _close(jc[k], pc[k])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), pc["pos"].numpy())
    step = jax.jit(lambda c, t: jax_lm.decode_step(jparams, jcfg, t, c))
    for i in range(3):
        t = _tokens(10 + i, (3,))
        jl, jc = step(jc, jnp.asarray(t))
        pl, pc = pt_lm.decode_step(pparams, pcfg, torch.from_numpy(t), pc)
        _close(jl, pl)


def test_padded_prefill_rows_match_their_own_prefill():
    """tests/test_serving.py's padding invariance for deepseek-v3-671b at
    atol = rtol = 1e-5: each right-padded row's logits and its latent
    cache up to its length against its own unpadded prefill, and the
    batched prefill against the JAX one; the greedy token equal."""
    jcfg, pcfg, jparams, pparams = _setup()
    toks = np.zeros((3, 9), np.int32)
    for i, p in enumerate(PAD_PROMPTS):
        toks[i, :len(p)] = p
    lengths = np.array([len(p) for p in PAD_PROMPTS], np.int32)
    lg_b, cache_b = pt_lm.prefill(pparams, pcfg, torch.from_numpy(toks),
                                  MAX_LEN, lengths=torch.from_numpy(lengths))
    jl, _ = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), MAX_LEN,
                           lengths=jnp.asarray(lengths))
    _close(jl, lg_b)
    for i, p in enumerate(PAD_PROMPTS):
        lg1, c1 = pt_lm.prefill(pparams, pcfg,
                                torch.tensor([p], dtype=torch.int32), MAX_LEN)
        for k in ("ckv", "krope"):
            torch.testing.assert_close(cache_b[k][:, i, :len(p)],
                                       c1[k][:, 0, :len(p)], rtol=TOL,
                                       atol=TOL)
        torch.testing.assert_close(lg_b[i], lg1[0], rtol=TOL, atol=TOL)
        assert int(lg_b[i].argmax()) == int(lg1[0].argmax())
        assert int(cache_b["pos"][i]) == len(p)


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


def test_slot_state_carries_the_latent_cache_and_rearm_leaves_it():
    _, pcfg, _, _ = _setup()
    state = pt_lm.init_slot_state(pcfg, 3, 16, device="cpu")
    cache = state["cache"]
    assert set(cache) == {"pos", "ckv", "krope"}
    assert tuple(cache["krope"].shape) == (3, 3, 16, 8)
    cache = dict(cache, ckv=torch.randn(cache["ckv"].shape),
                 pos=torch.tensor([4, 5, 6], dtype=torch.int32))
    out = pt_lm._reset_slot_rows(cache, torch.tensor([True, False, True]))
    assert out["ckv"] is cache["ckv"] and out["krope"] is cache["krope"]
    assert out["pos"].tolist() == [0, 5, 0]


def test_engine_kill_restore_keeps_the_streams(tmp_path):
    """Snapshots carry the latent cache: an engine killed after 5 decode
    steps and restored from its newest snapshot and the journal's tail
    finishes with the uninterrupted run's streams and round clock."""
    _, pcfg, _, pparams = _setup()
    ref = _engine(pcfg, pparams, decode_block=2)
    rids = [ref.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    want = ref.run_to_completion()
    eng = _engine(pcfg, pparams, decode_block=2, recover_dir=str(tmp_path),
                  snapshot_every=2)
    for p in PROMPTS:
        eng.submit(p, max_new=MAX_NEW)
    while eng.stats.decode_steps < 5:
        eng.step(2)
    assert len(eng.finished) < len(PROMPTS)
    eng.journal.close()
    del eng
    rec = pt_engine.ServingEngine.restore(str(tmp_path), pcfg, pparams,
                                          device="cpu")
    assert rec.recovery_report["snapshot_round"] is not None
    got = rec.run_to_completion()
    assert [got[r] for r in rids] == [want[r] for r in rids]
    assert tuple(tuple(want[r]) for r in rids) == _refs()
    assert rec.stats.decode_steps == ref.stats.decode_steps
    arrays, _ = recovery.snapshot_engine(rec)
    for k in ("ckv", "krope"):
        leaf = arrays[ckpt.SEP.join(("state", "cache", k))]
        assert torch.equal(leaf, rec.state["cache"][k])


def test_engine_under_faults_keeps_its_streams():
    """Dropped uploads and a NaN poured into the recurrent state (MLA's
    latent cache is not recurrent: ``corrupt_state`` touches no leaf of
    it, as for GQA) leave every greedy stream equal to generate_one's."""
    _, pcfg, _, pparams = _setup()
    inj = FaultInjector(seed=3, drop_rate=0.3, nan_at=((2, 0), (3, 1)))
    eng = _engine(pcfg, pparams, decode_block=2, faults=inj)
    rids = [eng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
    outs = eng.run_to_completion()
    assert tuple(tuple(outs[r]) for r in rids) == _refs()
    assert inj.counts()["drop_upload"] > 0
    assert not set(pt_lm._RECURRENT_CACHE_KEYS) & {"ckv", "krope"}


def test_serve_and_train_launchers_run_deepseek_v3_on_cpu(capsys, tmp_path):
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
