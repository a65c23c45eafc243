"""Port parity for the rest of the dense zoo: starcoder2-15b (LayerNorm,
biased attention and a plain GELU MLP, GQA 4 / 2, RoPE theta 1e5,
untied), pixtral-12b (a mistral-nemo trunk behind the stub patch
frontend: ``patch_proj`` and a prefix of projected patch embeddings) and
deepseek-67b (llama-style: RMSNorm, SwiGLU, GQA), trained, prefilled and
served; and LayerNorm itself.

The smoke configs (2-3 layers, d64, vocab 512, fp32) are built in both
packages, the JAX params bridged into the port, and the same
numpy-seeded inputs go through both.  Logits, caches and losses at atol
= rtol = 1e-5 (the same arithmetic, sums in another order); gradients
and the 5-step trajectories at the tolerances of
``test_torch_training.py`` (grads rtol 1e-4 / atol 1e-5; per-step
metrics rtol 1e-4; final params rtol 1e-3 / atol 1e-4).  LayerNorm
against ``repro.core.nn.layernorm_apply`` at 1e-6 in fp32 and within one
bf16 ulp in bf16.  Greedy streams must equal the JAX ``generate_one``
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
from repro.core import nn as jax_nn
from repro.data import lm_corpus as jax_corpus
from repro.models import lm as jax_lm
from repro.serving import engine as jax_engine
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_ts
from repro_torch import bridge, tree
from repro_torch.configs import archs as pt_archs
from repro_torch.core import nn as pt_nn
from repro_torch.models import lm as pt_lm
from repro_torch.serving import engine as pt_engine
from repro_torch.training import optimizer as pt_opt
from repro_torch.training import train_step as pt_ts

ARCHS = ("starcoder2-15b", "pixtral-12b", "deepseek-67b")
# the forward / loss / prefill cases: each arch on text, and pixtral-12b
# with its patch prefix
CASES = ARCHS + ("pixtral-12b+patches",)
TOL = 1e-5
MAX_LEN = 64
# tests/test_serving.py's prompts for the engine against generate_one
PROMPTS = ([1, 2, 3, 4], [5, 6, 7], [2, 4, 6, 8, 10, 1])
MAX_NEW = 6


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


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    """The JAX decode step of ``arch``, jitted once for every test."""
    jcfg, _, jparams, _ = _setup(arch)
    return jax.jit(lambda c, t: jax_lm.decode_step(jparams, jcfg, t, c))


def _case(case):
    """(arch, patch embeddings (B 2, the config's prefix) or None)."""
    arch, _, patches = case.partition("+")
    if not patches:
        return arch, None
    cfg = pt_archs.smoke(arch)
    pe = np.random.default_rng(5).standard_normal(
        (2, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return arch, pe


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


def _batch(step, patches=None, batch=2, seq=16):
    if "train" not in _CORPUS:
        _CORPUS["train"] = jax_corpus.build_corpus(target_bytes=20_000)[0]
    out = dict(jax_corpus.lm_batch(_CORPUS["train"], 0, step, batch, seq))
    if patches is not None:
        out["patch_embeds"] = patches
    return out


# ---------------------------------------------------------------------------
# Configs, params, LayerNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("get", ["get", "smoke"])
def test_config_equals_reference(arch, get):
    j = getattr(jax_archs, get)(arch)
    p = getattr(pt_archs, get)(arch)
    for f in dataclasses.fields(p):
        assert getattr(j, f.name) == getattr(p, f.name), (get, f.name)
    assert (j.head_dim_, j.padded_vocab) == (p.head_dim_, p.padded_vocab)


# deepseek-67b's trunk with MLA for its attention, at smoke widths
_MLA = dict(attn_kind="mla", mla_q_lora=32, mla_kv_lora=16, mla_rope_dim=8,
            mla_qk_nope_dim=16, mla_v_dim=16)


def test_mla_is_registered_and_runs_on_the_deepseek_67b_trunk():
    """deepseek-v3-671b is registered; deepseek-67b's trunk with MLA in
    place of GQA builds its own params in the bridged tree's layout and
    gives the reference's logits."""
    assert "deepseek-v3-671b" in pt_archs.all_names()
    jcfg, pcfg, jparams, pparams = _setup("deepseek-67b", **_MLA)
    own = pt_lm.init_params(torch.Generator().manual_seed(0), pcfg,
                            device="cpu")
    assert {p: tuple(a.shape) for p, a in tree.leaves_with_path(own)} == \
        {p: tuple(a.shape) for p, a in tree.leaves_with_path(pparams)}
    toks = np.random.default_rng(9).integers(0, 512, (2, 11)).astype(
        np.int32)
    want, _ = jax_lm.forward(jparams, jcfg, jnp.asarray(toks))
    got, _ = pt_lm.forward(pparams, pcfg, torch.from_numpy(toks))
    _close(want, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridged_params_and_own_init_share_the_tree(arch):
    _, pcfg, jparams, pparams = _setup(arch)
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == len(tree.leaves(pparams))
    paths = {".".join(k.key for k in path) for path, _ in flat}
    assert ("patch_proj.kernel" in paths) == (arch == "pixtral-12b")
    assert "unembed.kernel" in paths
    if arch == "starcoder2-15b":
        for leaf in ("norm1.bias", "norm2.scale", "mixer.wq.bias",
                     "mixer.wo.bias", "mlp.up.bias", "mlp.down.bias"):
            assert f"layers.blocks.{leaf}" in paths, leaf
        assert "final_norm.bias" in paths
        assert "layers.blocks.mlp.gate.kernel" not in paths
    own = pt_lm.init_params(torch.Generator().manual_seed(0), pcfg,
                            device="cpu")
    got = {p: (tuple(a.shape), a.dtype) for p, a in tree.leaves_with_path(own)}
    want = {p: (tuple(a.shape), a.dtype)
            for p, a in tree.leaves_with_path(pparams)}
    assert got == want
    assert pt_lm.kernel_tier(pcfg) == "unfused"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """fp32 at 1e-6; bf16 within one bf16 ulp of the reference's value
    (the same fp32 arithmetic, one rounding at the end)."""
    rng = np.random.default_rng(3)
    x = (3.0 * rng.standard_normal((5, 7, 96)) + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(96)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = jax_nn.norm_apply("layernorm",
                             {"scale": jnp.asarray(scale, jdt),
                              "bias": jnp.asarray(bias, jdt)},
                             jnp.asarray(x, jdt))
    p = bridge.params_from_jax({"scale": np.asarray(jnp.asarray(scale, jdt)),
                                "bias": np.asarray(jnp.asarray(bias, jdt))},
                               device="cpu")
    xt = bridge.leaf_from_numpy(np.asarray(jnp.asarray(x, jdt)))
    got = pt_nn.norm_apply("layernorm", p, xt)
    assert got.dtype == xt.dtype and tuple(got.shape) == x.shape
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert np.all(np.abs(got - want) <= ulp)
    init = pt_nn.norm_init("layernorm", 96)
    assert set(init) == {"scale", "bias"}
    with pytest.raises(ValueError):
        pt_nn.norm_apply("groupnorm", init, xt)


# ---------------------------------------------------------------------------
# The parallel trunk: logits, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_forward_logits_match_jax(case):
    arch, pe = _case(case)
    jcfg, pcfg, jparams, pparams = _setup(arch)
    toks = _tokens(1, (2, 11))
    jkw = {} if pe is None else {"patch_embeds": jnp.asarray(pe)}
    pkw = {} if pe is None else {"patch_embeds": torch.from_numpy(pe)}
    want, _ = jax_lm.forward(jparams, jcfg, jnp.asarray(toks), **jkw)
    got, aux = pt_lm.forward(pparams, pcfg, torch.from_numpy(toks), **pkw)
    prefix = 0 if pe is None else pe.shape[1]
    assert tuple(got.shape) == (2, prefix + 11, pcfg.padded_vocab)
    _close(want, got)
    assert float(aux) == 0.0


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_jax(case):
    arch, pe = _case(case)
    jcfg, pcfg, jparams, pparams = _setup(arch)
    batch = _batch(0, pe)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm.loss_fn(p, jcfg, b), has_aux=True))(
        jparams, batch)
    (pl, pm), pg = pt_ts.value_and_grad(pt_ts.make_loss_fn(pcfg), pparams,
                                        pt_ts.batch_to(batch, "cpu"))
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL)
    assert float(pm["ntokens"]) == batch["labels"].size
    _trees_close(jg, pg, rtol=1e-4, atol=1e-5)
    if pe is None and arch == "pixtral-12b":
        # text only: the patch projection gets no gradient
        assert float(pg["patch_proj"]["kernel"].abs().max()) == 0.0
    for leaf in tree.leaves(pparams):
        leaf.requires_grad_(False)


def test_remat_full_matches_no_remat():
    """starcoder2-15b's LayerNorm and biased layers under checkpoint: the
    same loss and gradients, bit for bit."""
    _, pcfg, _, pparams = _setup("starcoder2-15b")
    batch = pt_ts.batch_to(_batch(1), "cpu")
    outs = []
    for remat in ("none", "full"):
        cfg = pcfg.replace(remat=remat)
        outs.append(pt_ts.value_and_grad(pt_ts.make_loss_fn(cfg), pparams,
                                         batch))
    (l0, _), g0 = outs[0]
    (l1, _), g1 = outs[1]
    assert float(l0) == float(l1)
    for (k, a), (_, b) in zip(_flat(g0), _flat(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(k))
    for leaf in tree.leaves(pparams):
        leaf.requires_grad_(False)


@pytest.mark.parametrize("case", ["starcoder2-15b", "pixtral-12b+patches"])
def test_five_step_trajectory_matches_jax(case):
    arch, pe = _case(case)
    jcfg, pcfg, jparams, pparams = _setup(arch)
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
        batch = _batch(step, pe)
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

@pytest.mark.parametrize("case,padded", [
    ("starcoder2-15b", False), ("starcoder2-15b", True),
    ("deepseek-67b", False), ("deepseek-67b", True),
    ("pixtral-12b", False), ("pixtral-12b+patches", False)])
def test_prefill_then_decode_matches_jax(case, padded):
    """Right-padded prompts too, but not on pixtral-12b: a patch frontend
    refuses ``lengths``, in the reference as here."""
    arch, pe = _case(case)
    jcfg, pcfg, jparams, pparams = _setup(arch)
    bsz = 3 if pe is None else 2
    toks = _tokens(2, (bsz, 9))
    jkw, pkw = {}, {}
    if padded:
        lengths = np.array([9, 4, 1], np.int32)
        jkw["lengths"], pkw["lengths"] = (jnp.asarray(lengths),
                                          torch.from_numpy(lengths))
    if pe is not None:
        jkw["patch_embeds"], pkw["patch_embeds"] = (jnp.asarray(pe),
                                                    torch.from_numpy(pe))
    max_len = 32
    jl, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), max_len, **jkw)
    pl, pc = pt_lm.prefill(pparams, pcfg, torch.from_numpy(toks), max_len,
                           **pkw)
    assert set(pc) == set(jc) == {"pos", "k", "v"}
    assert tuple(pc["k"].shape) == (pcfg.n_layers, bsz, max_len,
                                    pcfg.n_kv_heads, pcfg.head_dim_)
    _close(jl, pl)
    for k in ("k", "v"):
        _close(jc[k], pc[k])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), pc["pos"].numpy())
    step = _jax_step(arch)
    for i in range(3):
        t = _tokens(10 + i, (bsz,))
        jl, jc = step(jc, jnp.asarray(t))
        pl, pc = pt_lm.decode_step(pparams, pcfg, torch.from_numpy(t), pc)
        _close(jl, pl)
    for k in ("k", "v"):
        _close(jc[k], pc[k])


def test_prefill_with_patches_and_lengths_is_refused():
    """As the reference: a patch frontend refuses right-padded prompts,
    with or without patches given; a patch prefix that with the prompt
    passes ``max_len`` raises."""
    _, pcfg, _, pparams = _setup("pixtral-12b")
    _, pe = _case("pixtral-12b+patches")
    toks = torch.ones((2, 5), dtype=torch.int32)
    lengths = torch.tensor([5, 2], dtype=torch.int32)
    for kw in ({}, {"patch_embeds": torch.from_numpy(pe)}):
        with pytest.raises(NotImplementedError, match="patch frontend"):
            pt_lm.prefill(pparams, pcfg, toks, 32, lengths=lengths, **kw)
    with pytest.raises(ValueError, match="max_len"):
        pt_lm.prefill(pparams, pcfg, toks, 12,
                      patch_embeds=torch.from_numpy(pe))


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
    """pixtral-12b serves text, as the reference's engine does."""
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


def test_sampled_streams_equal_jax_engine():
    jcfg, pcfg, jparams, pparams = _setup("starcoder2-15b")
    kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    jeng = jax_engine.ServingEngine(jcfg, jparams, max_batch=2,
                                    max_len=MAX_LEN, decode_block=2, seed=7)
    jr = [jeng.submit(p, max_new=MAX_NEW, **kw) for p in PROMPTS]
    jouts = jeng.run_to_completion()
    eng = _engine(pcfg, pparams, decode_block=2, seed=7)
    pr = [eng.submit(p, max_new=MAX_NEW, **kw) for p in PROMPTS]
    pouts = eng.run_to_completion()
    assert [pouts[r] for r in pr] == [jouts[r] for r in jr]


def test_decode_row_is_independent_of_batch():
    """starcoder2-15b smoke on the CPU: a row stepped in a batch of 8
    equals the row stepped alone (the products in tiles of 8 rows)."""
    _, pcfg, _, pparams = _setup("starcoder2-15b")
    toks = torch.from_numpy(_tokens(7, (8, 5)))
    c8 = pt_lm.init_cache(pcfg, 8, 16, device="cpu")
    c1 = pt_lm.init_cache(pcfg, 1, 16, device="cpu")
    for t in range(toks.shape[1]):
        l8, c8 = pt_lm.decode_step(pparams, pcfg, toks[:, t], c8)
        l1, c1 = pt_lm.decode_step(pparams, pcfg, toks[3:4, t], c1)
        assert torch.equal(l8[3:4], l1), t
    for k in ("k", "v"):
        assert torch.equal(c8[k][:, 3:4], c1[k]), k


def test_serve_and_train_launchers_run_starcoder2_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve, train
    serve.main(["--arch", "starcoder2-15b", "--smoke", "--device", "cpu",
                "--prompts", "To be", "Hi", "--max-new", "4",
                "--decode-block", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "kernel tier: unfused" in out and "superstep K=2" in out
    serve.main(["--arch", "starcoder2-15b", "--smoke", "--device", "cpu",
                "--prompts", "To be", "--max-new", "3", "--prefill",
                "--max-len", "32"])
    assert "prefill:" in capsys.readouterr().out
    report = train.main(["--arch", "starcoder2-15b", "--smoke", "--device",
                         "cpu", "--steps", "2", "--batch", "2", "--seq",
                         "16", "--ckpt-dir", str(tmp_path),
                         "--log-every", "1"])
    assert report.failures_recovered == 0
    assert "step 2:" in capsys.readouterr().out
