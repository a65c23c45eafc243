"""Port parity for ``models/rope.py`` and ``models/attention.py``'s GQA
half against the JAX package.

Inputs come from a numpy seed and go through the JAX function and its
port on the CPU.  fp32 at atol = rtol = 1e-5: the same arithmetic, the
einsums summed in another order.  The blocked attention runs at tiles of
8 / 8 so that several q and kv tiles, a ragged last tile, padded keys and
skipped causal tiles all run.
"""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro.models import rope as jax_rope
from repro_torch import bridge
from repro_torch.models import attention as pt_attn
from repro_torch.models import rope as pt_rope

TOL = 1e-5


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cfg(n_heads=4, n_kv_heads=2, head_dim=8, d_model=32, rope=True,
         q_chunk=8, kv_chunk=8):
    """The fields the attention functions read, for both packages."""
    return types.SimpleNamespace(
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
        head_dim_=head_dim, attn_bias=False, cdtype=jnp.float32, rope=rope,
        rope_theta=10000.0, attn_q_chunk=q_chunk, attn_kv_chunk=kv_chunk)


def _pt_cfg(jcfg):
    return types.SimpleNamespace(**{**vars(jcfg), "cdtype": torch.float32})


@functools.lru_cache(maxsize=None)
def _gqa_params(n_heads, n_kv_heads):
    jcfg = _cfg(n_heads, n_kv_heads)
    jp = jax_attn.gqa_init(jax.random.PRNGKey(3), jcfg)
    return jcfg, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                            device="cpu")


@pytest.mark.parametrize("rank", [3, 4])
def test_rope_at_offset_positions_matches_jax(rank):
    rng = np.random.default_rng(0)
    shape = (2, 7, 3, 16) if rank == 4 else (2, 7, 16)
    x = _randn(rng, *shape)
    pos = (np.arange(7)[None] + np.array([[5], [900]])).astype(np.int32)
    _close(jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0),
           pt_rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              500.0))
    _close(jax_rope.rope_freqs(16, 10000.0), pt_rope.rope_freqs(16, 1e4))


def test_rope_keeps_bf16_and_rotates_in_fp32():
    x = torch.randn((1, 5, 2, 8), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5)[None]
    got = pt_rope.apply_rope(x.bfloat16(), pos)
    assert got.dtype == torch.bfloat16
    want = pt_rope.apply_rope(x.bfloat16().float(), pos).bfloat16()
    assert torch.equal(got, want)


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk,q_offset", [(21, 21, 0), (13, 27, 14),
                                            (5, 30, 3)])
def test_blocked_attention_matches_jax(groups, causal, tq, tk, q_offset):
    """Several tiles, a ragged last tile, padded keys, causal tiles
    skipped past each q tile's last position, and q offset into k."""
    rng = np.random.default_rng(groups * 7 + tq)
    kv = 2
    q = _randn(rng, 2, tq, kv * groups, 8)
    k = _randn(rng, 2, tk, kv, 8)
    v = _randn(rng, 2, tk, kv, 8)
    kw = dict(causal=causal, q_chunk=8, kv_chunk=8, q_offset=q_offset)
    want = jax_attn.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    got = pt_attn.blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), **kw)
    _close(want, got)


def test_blocked_attention_tiles_do_not_change_the_result():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(_randn(rng, 2, 19, 4, 8)),
               torch.from_numpy(_randn(rng, 2, 19, 2, 8)),
               torch.from_numpy(_randn(rng, 2, 19, 2, 8)))
    one = pt_attn.blocked_attention(q, k, v, causal=True)
    tiled = pt_attn.blocked_attention(q, k, v, causal=True, q_chunk=4,
                                      kv_chunk=6)
    torch.testing.assert_close(tiled, one, rtol=TOL, atol=TOL)


def test_decode_attention_with_per_row_lengths_matches_jax():
    rng = np.random.default_rng(2)
    q = _randn(rng, 3, 4, 8)
    kc, vc = _randn(rng, 3, 11, 2, 8), _randn(rng, 3, 11, 2, 8)
    length = np.array([1, 6, 11], np.int32)
    _close(jax_attn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                     jnp.asarray(vc), jnp.asarray(length)),
           pt_attn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                    torch.from_numpy(vc),
                                    torch.from_numpy(length)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_row_is_independent_of_batch(dtype):
    """A row attended in a batch equals the row attended alone, bit for
    bit (rows run in padded groups of DECODE_ROWS, here across two
    groups; bf16 comes back in bf16)."""
    rng = np.random.default_rng(9)
    n = pt_attn.DECODE_ROWS + 3
    q = torch.from_numpy(_randn(rng, n, 4, 8)).to(dtype)
    kc = torch.from_numpy(_randn(rng, n, 12, 1, 8)).to(dtype)
    vc = torch.from_numpy(_randn(rng, n, 12, 1, 8)).to(dtype)
    length = torch.from_numpy(rng.integers(1, 13, n).astype(np.int32))
    both = pt_attn.decode_attention(q, kc, vc, length)
    assert both.dtype == dtype
    for b in range(n):
        one = pt_attn.decode_attention(q[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                                       length[b:b + 1])
        assert torch.equal(both[b:b + 1], one), b


@pytest.mark.parametrize("n_kv_heads", [1, 2])
def test_gqa_decode_step_scatter_equals_the_blend(n_kv_heads):
    """The new k / v go into the caches in place, every other entry left
    bit for bit, a position past the end (a dead row that keeps stepping)
    writing nothing; caches and output match the reference's (whose new
    k / v are its own projections: equal to rounding)."""
    jcfg, jp, pp = _gqa_params(4, n_kv_heads)
    rng = np.random.default_rng(n_kv_heads)
    x = _randn(rng, 3, 32)
    kc = _randn(rng, 3, 10, n_kv_heads, 8)
    vc = _randn(rng, 3, 10, n_kv_heads, 8)
    pos = np.array([0, 7, 12], np.int32)
    jo, jk, jv = jax_attn.gqa_decode_step(jp, jcfg, jnp.asarray(x),
                                          jnp.asarray(kc), jnp.asarray(vc),
                                          jnp.asarray(pos))
    pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ptr = (pk.data_ptr(), pv.data_ptr())
    po, pk2, pv2 = pt_attn.gqa_decode_step(pp, _pt_cfg(jcfg),
                                           torch.from_numpy(x), pk, pv,
                                           torch.from_numpy(pos))
    assert pk2 is pk and pv2 is pv and (pk.data_ptr(), pv.data_ptr()) == ptr
    for want, got, before in ((jk, pk, kc), (jv, pv, vc)):
        _close(want, got)
        written = np.zeros(before.shape[:2], bool)
        written[[0, 1], [0, 7]] = True                    # pos 12 >= 10
        np.testing.assert_array_equal(got.numpy()[~written],
                                      before[~written])
    _close(jo, po)


def test_cache_insert_equals_the_blend_bit_for_bit():
    rng = np.random.default_rng(5)
    cache = _randn(rng, 4, 6, 1, 3)
    new = _randn(rng, 4, 1, 3)
    pos = np.array([5, 0, 6, 2], np.int32)
    want = jax_attn._cache_insert(jnp.asarray(cache), jnp.asarray(new),
                                  jnp.asarray(pos))
    got = pt_attn._cache_insert(torch.from_numpy(cache.copy()),
                                torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rope", [True, False])
def test_gqa_prefill_and_project_kv_match_jax(rope):
    jcfg, jp, pp = _gqa_params(4, 2)
    jcfg = types.SimpleNamespace(**{**vars(jcfg), "rope": rope})
    rng = np.random.default_rng(6)
    x = _randn(rng, 2, 19, 32)
    pos = np.arange(19, dtype=np.int32)[None]
    jo, jk, jv = jax_attn.gqa_prefill(jp, jcfg, jnp.asarray(x),
                                      positions=jnp.asarray(pos))
    po, pk, pv = pt_attn.gqa_prefill(pp, _pt_cfg(jcfg), torch.from_numpy(x),
                                     positions=torch.from_numpy(pos))
    for w, g in ((jo, po), (jk, pk), (jv, pv)):
        _close(w, g)
    jk, jv = jax_attn.gqa_project_kv(jp, jcfg, jnp.asarray(x),
                                     jnp.asarray(pos))
    pk, pv = pt_attn.gqa_project_kv(pp, _pt_cfg(jcfg), torch.from_numpy(x),
                                    torch.from_numpy(pos))
    _close(jk, pk)
    _close(jv, pv)


@pytest.mark.parametrize("causal", [False, True])
def test_gqa_apply_and_its_gradient_match_jax(causal):
    """Forward and the gradient of a scalar of it with respect to the
    weights and the input: the port's backward recomputes every kv tile
    under ``torch.utils.checkpoint``, the reference's under
    ``jax.checkpoint``."""
    jcfg, jp, pp = _gqa_params(4, 2)
    rng = np.random.default_rng(7)
    x = _randn(rng, 2, 21, 32)
    w = _randn(rng, 2, 21, 32)
    pos = np.arange(21, dtype=np.int32)[None]

    def jloss(p, x_):
        y = jax_attn.gqa_apply(p, jcfg, x_, positions=jnp.asarray(pos),
                               causal=causal)
        return jnp.sum(y * jnp.asarray(w)), y

    (_, jy), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(jp, jnp.asarray(x))
    leaves = [t for d in pp.values() for t in d.values()]
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    py = pt_attn.gqa_apply(pp, _pt_cfg(jcfg), xt,
                           positions=torch.from_numpy(pos), causal=causal)
    grads = torch.autograd.grad((py * torch.from_numpy(w)).sum(),
                                leaves + [xt])
    _close(jy, py)
    jleaves = [np.asarray(jg[k]["kernel"]) for k in pp]
    for want, got in zip(jleaves + [np.asarray(jgx)], grads):
        _close(want, got, tol=1e-4)
    for t in leaves:
        t.requires_grad_(False)


def test_blocked_attention_backward_saves_no_score_tile():
    """The kv-tile body runs under checkpoint when autograd records: the
    graph keeps no (Tq, Tk) fp32 score tile of the forward."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(_randn(rng, 1, 16, 2, 4)).requires_grad_(True)
    k = torch.from_numpy(_randn(rng, 1, 16, 1, 4))
    v = torch.from_numpy(_randn(rng, 1, 16, 1, 4))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = pt_attn.blocked_attention(q, k, v, causal=True, q_chunk=16,
                                        kv_chunk=8)
    assert (1, 1, 2, 16, 8) not in saved       # a (B, K, G, Tq, Tk) tile
    out.sum().backward()
    assert torch.isfinite(q.grad).all()


def _mla_cfg():
    """``_cfg``'s fields plus MLA's, at tiles of 8 / 8."""
    return types.SimpleNamespace(**{**vars(_cfg(n_heads=4, n_kv_heads=4)),
                                    "attn_kind": "mla", "mla_q_lora": 24,
                                    "mla_kv_lora": 12, "mla_rope_dim": 8,
                                    "mla_qk_nope_dim": 8, "mla_v_dim": 12})


def test_mla_matches_the_reference_at_tiles_of_8():
    """``mla_init``'s tree, ``mla_apply`` and ``mla_prefill`` over several
    q and kv tiles (T 19 at tiles of 8: v padded from 12 to the qk head
    size 16), then two absorbed ``mla_decode_step`` calls, against the
    reference's."""
    jcfg = _mla_cfg()
    pcfg = _pt_cfg(jcfg)
    jp = jax_attn.mla_init(jax.random.PRNGKey(4), jcfg)
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    own = pt_attn.mla_init(torch.Generator().manual_seed(0), pcfg)
    assert {k: {n: tuple(a.shape) for n, a in v.items()}
            for k, v in own.items()} == \
        {k: {n: tuple(a.shape) for n, a in v.items()} for k, v in pp.items()}
    rng = np.random.default_rng(8)
    x = _randn(rng, 2, 19, 32)
    pos = np.arange(19)[None, :]
    _close(jax_attn.mla_apply(jp, jcfg, jnp.asarray(x),
                              positions=jnp.asarray(pos)),
           pt_attn.mla_apply(pp, pcfg, torch.from_numpy(x),
                             positions=torch.from_numpy(pos)))
    jo, jckv, jkr = jax_attn.mla_prefill(jp, jcfg, jnp.asarray(x),
                                         positions=jnp.asarray(pos))
    po, pckv, pkr = pt_attn.mla_prefill(pp, pcfg, torch.from_numpy(x),
                                        positions=torch.from_numpy(pos))
    for a, b in ((jo, po), (jckv, pckv), (jkr, pkr)):
        _close(a, b)
    jc = [jnp.pad(a, ((0, 0), (0, 5), (0, 0))) for a in (jckv, jkr)]
    pc = [torch.nn.functional.pad(a, (0, 0, 0, 5)) for a in (pckv, pkr)]
    p_now = np.array([19, 20], np.int32)
    for _ in range(2):
        xt = _randn(rng, 2, 32)
        jo, *jc = jax_attn.mla_decode_step(jp, jcfg, jnp.asarray(xt), *jc,
                                           jnp.asarray(p_now))
        po, *pc = pt_attn.mla_decode_step(pp, pcfg, torch.from_numpy(xt),
                                          *pc, torch.from_numpy(p_now))
        _close(jo, po)
        for a, b in zip(jc, pc):
            _close(a, b)
        p_now = p_now + 1
