"""Port parity for the serving engine and the sampling key chain.

Greedy engine streams of the port must equal the JAX ``generate_one``
token for token on the smoke configs (bridged weights), for decode block
K in {1, 4} and prompt chunk C in {1, 4}, with requests arriving while
others run and slots being reused; the port's streams must be identical
across C; the slot-step identity of ``EngineStats`` must hold.  The key
chain (``make_keys``, ``split``, the Gumbel draw) must equal JAX's bit
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
from repro.serving import engine as jax_engine
from repro.serving import sampling as jax_sampling
from repro_torch import bridge
from repro_torch.configs import archs as pt_archs
from repro_torch.models import lm as pt_lm
from repro_torch.serving import engine as pt_engine
from repro_torch.serving import sampling as pt_sampling

MAX_LEN = 48
PROMPTS = ([5, 17, 200, 3], [9], [250, 1, 2, 3, 4, 5, 6], [42, 42],
           [7, 8, 9])
MAX_NEW = (6, 4, 5, 7, 3)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = jax_archs.smoke(arch)
    pcfg = pt_archs.smoke(arch)
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    refs = tuple(tuple(jax_engine.generate_one(jcfg, jparams, p, max_new=m,
                                               max_len=MAX_LEN))
                 for p, m in zip(PROMPTS, MAX_NEW))
    return jcfg, pcfg, jparams, pparams, refs


def _serve(pcfg, pparams, k, c, late_kw=None, **submit_kw):
    """Two requests first, the rest arriving after two host steps: more
    requests than slots, so rows retire and re-arm mid-superstep.
    ``late_kw``: the late requests' controls, if they differ."""
    eng = pt_engine.ServingEngine(pcfg, pparams, max_batch=2,
                                  max_len=MAX_LEN, decode_block=k,
                                  prompt_chunk=c, device="cpu", seed=7)
    rids = [eng.submit(p, max_new=m, **submit_kw)
            for p, m in zip(PROMPTS[:2], MAX_NEW[:2])]
    eng.step()
    eng.step()
    late = submit_kw if late_kw is None else late_kw
    rids += [eng.submit(p, max_new=m, **late)
             for p, m in zip(PROMPTS[2:], MAX_NEW[2:])]
    outs = eng.run_to_completion()
    return eng, [tuple(outs[r]) for r in rids]


@pytest.mark.parametrize("arch", ["mingru-lm", "minlstm-lm"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("c", [1, 4])
def test_engine_greedy_streams_equal_jax_generate_one(arch, k, c):
    _, pcfg, _, pparams, refs = _setup(arch)
    eng, streams = _serve(pcfg, pparams, k, c)
    assert tuple(streams) == refs
    st = eng.stats
    assert st.completed == len(PROMPTS)
    assert st.shard_identities_ok()
    assert st.prefill_tokens == sum(len(p) for p in PROMPTS)
    # the host's chunk-round plan never misses: every prompt packs into
    # ceil(len / C) rounds
    assert st.prefill_rounds == sum(-(-len(p) // c) for p in PROMPTS)


def test_port_streams_identical_across_prompt_chunk():
    _, pcfg, _, pparams, _ = _setup("mingru-lm")
    base = _serve(pcfg, pparams, 2, 1)[1]
    for c in (2, 3, 8):
        assert _serve(pcfg, pparams, 2, c)[1] == base


def test_generate_one_matches_jax():
    _, pcfg, _, pparams, refs = _setup("minlstm-lm")
    got = pt_engine.generate_one(pcfg, pparams, list(PROMPTS[2]),
                                 max_new=MAX_NEW[2], max_len=MAX_LEN,
                                 device="cpu")
    assert tuple(got) == refs[2]


def test_make_keys_and_split_equal_jax_bit_for_bit():
    for seed, batch in ((0, 4), (7, 8), (2**31 + 5, 3)):
        want = np.asarray(jax_sampling.make_keys(seed, batch))
        got = pt_sampling.make_keys(seed, batch)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        want_s = np.asarray(jax.vmap(jax.random.split)(jnp.asarray(want)))
        np.testing.assert_array_equal(pt_sampling.split(got).numpy(),
                                      want_s.astype(np.int64))


def test_key_chain_and_gumbel_equal_jax():
    keys = jax_sampling.make_keys(3, 4)
    pt_keys = pt_sampling.make_keys(3, 4)
    # two chain advances, then the use-key of the third position
    for _ in range(2):
        keys = jax.vmap(jax.random.split)(keys)[:, 0]
    np.testing.assert_array_equal(
        pt_sampling.advance_keys(pt_keys, torch.full((4,), 2)).numpy(),
        np.asarray(keys).astype(np.int64))
    use = jax.vmap(jax.random.split)(keys)[:, 1]
    tiny = np.finfo(np.float32).tiny
    want_u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (256,), minval=tiny, maxval=1.0))(use))
    pt_use = pt_sampling.split(
        pt_sampling.advance_keys(pt_keys, torch.full((4,), 2)))[:, 1]
    np.testing.assert_array_equal(pt_sampling.uniform(pt_use, 256).numpy(),
                                  want_u)
    # -log(-log(u)): XLA's and PyTorch's fp32 log may differ in the last
    # ulp, so the Gumbel noise is held to fp32 rounding, not bits
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (256,)))(use))
    table = pt_sampling.gumbel_table(pt_sampling.make_keys(3, 4), 3, 256)
    np.testing.assert_allclose(table[:, 2].numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_sampled_streams_equal_jax_engine():
    """Seeded sampled streams: same weights, prompts, seed and controls
    through both engines."""
    jcfg, pcfg, jparams, pparams, _ = _setup("mingru-lm")
    kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    jeng = jax_engine.ServingEngine(jcfg, jparams, max_batch=2,
                                    max_len=MAX_LEN, decode_block=2,
                                    seed=7)
    jr = [jeng.submit(p, max_new=m, **kw)
          for p, m in zip(PROMPTS[:2], MAX_NEW[:2])]
    jeng.step()
    jeng.step()
    jr += [jeng.submit(p, max_new=m, **kw)
           for p, m in zip(PROMPTS[2:], MAX_NEW[2:])]
    jouts = jeng.run_to_completion()
    _, streams = _serve(pcfg, pparams, 2, 1, **kw)
    assert streams == [tuple(jouts[r]) for r in jr]


def test_greedy_then_sampled_streams_equal_jax_engine():
    """Greedy requests first, sampled ones arriving later, at C = 4: the
    engine tells the superstep when a sampled request is armed or staged,
    the key chain catches up over the greedy emissions, and the host picks
    the chunk rounds."""
    jcfg, pcfg, jparams, pparams, _ = _setup("mingru-lm")
    kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    jeng = jax_engine.ServingEngine(jcfg, jparams, max_batch=2,
                                    max_len=MAX_LEN, decode_block=2,
                                    prompt_chunk=4, seed=7)
    jr = [jeng.submit(p, max_new=m) for p, m in zip(PROMPTS[:2], MAX_NEW[:2])]
    jeng.step()
    jeng.step()
    jr += [jeng.submit(p, max_new=m, **kw)
           for p, m in zip(PROMPTS[2:], MAX_NEW[2:])]
    jouts = jeng.run_to_completion()
    _, streams = _serve(pcfg, pparams, 2, 4, late_kw=kw)
    assert streams == [tuple(jouts[r]) for r in jr]


@pytest.mark.parametrize("plan", ["none", "all", "device"])
def test_superstep_chunk_round_plan_changes_no_token(plan):
    """Whatever rounds the caller marks for the chunk kernel, the tokens
    are those of the device's own choice: an unmarked prefilling round
    takes one prompt token, a marked idle one is the step at valid 1."""
    _, pcfg, _, pparams, refs = _setup("mingru-lm")
    state = pt_lm.init_slot_state(pcfg, 2, MAX_LEN, device="cpu")
    for slot, p in enumerate(PROMPTS[2:4]):
        state["s_prompt"][slot, :len(p)] = torch.tensor(p)
        state["s_prompt_len"][slot] = len(p)
        state["s_rid"][slot] = slot
        state["s_remaining"][slot] = 4
        state["s_valid"][slot] = True
    n = 10
    rounds = {"none": [False] * n, "all": [True] * n, "device": None}[plan]
    toks, _, _, counters = pt_lm.superstep(pparams, pcfg, state, n,
                                           prompt_chunk=4, sampled=False,
                                           chunk_rounds=rounds)
    for slot in range(2):
        got = [int(t) for t in toks[slot] if t >= 0]
        assert tuple(got) == refs[2 + slot][:4]
    want_rounds = {"none": 9, "all": 3, "device": 3}[plan]
    assert int(counters["prefill_rounds"]) == want_rounds
