"""Port parity for ``remat="dots"`` (``models/lm.py`` ``_remat``): the
layer under a non-reentrant ``torch.utils.checkpoint`` whose selective
policy keeps the products with no batch dimension and recomputes the
rest, the counterpart of the reference's ``jax.checkpoint`` with
``dots_with_no_batch_dims_saveable``.

For a minRNN LM (mingru-lm), the attention trunk (gemma-2b) and the
encoder-decoder (whisper-base), smoke configs in fp32: the loss and every
gradient under "dots" against the JAX package's "dots" (loss atol = rtol
= 1e-5, gradients rtol 1e-4 / atol 1e-5, the tolerances of
``test_torch_training.py``), and against the port's "none" bit for bit:
the policy changes what the backward keeps, not a value.  Then what it
recomputes: no unbatched product, everything else.
"""

from __future__ import annotations

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import archs as jax_archs
from repro.data import lm_corpus as jax_corpus
from repro.training import train_step as jax_ts
from repro_torch import bridge, tree
from repro_torch.configs import archs as pt_archs
from repro_torch.training import train_step as pt_ts

ARCHS = ("mingru-lm", "gemma-2b", "whisper-base")
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, pcfg = jax_archs.smoke(arch), pt_archs.smoke(arch)
    jparams = jax_ts.model_for(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, pcfg, jparams, pparams


@functools.lru_cache(maxsize=None)
def _batch(arch):
    cfg = pt_archs.smoke(arch)
    data = jax_corpus.build_corpus(target_bytes=20_000)[0]
    out = dict(jax_corpus.lm_batch(data, 0, 0, 2, 16))
    if cfg.family == "encdec":
        out["frames"] = np.random.default_rng(3).standard_normal(
            (2, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    else:
        out = {k: np.minimum(v, cfg.vocab_size - 1) for k, v in out.items()}
    return out


def _flat(t, path=()):
    if isinstance(t, dict):
        for k in t:
            yield from _flat(t[k], path + (k,))
    else:
        yield path, t


def _port(pcfg, pparams, batch, remat):
    return pt_ts.value_and_grad(
        pt_ts.make_loss_fn(pcfg.replace(remat=remat)),
        tree.tree_map(torch.clone, pparams), pt_ts.batch_to(batch, "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_matches_jax_dots_and_the_port_without_remat(arch):
    jcfg, pcfg, jparams, pparams = _setup(arch)
    batch = _batch(arch)
    jd = jcfg.replace(remat="dots")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        jax_ts.make_loss_fn(jd), has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    (pl, _), pg = _port(pcfg, pparams, batch, "dots")
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL, atol=TOL)
    jflat = dict(_flat(jax.tree.map(np.asarray, jg)))
    pflat = dict(_flat(pg))
    assert set(jflat) == set(pflat)
    for k, v in jflat.items():
        np.testing.assert_allclose(pflat[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=str(k))
    (nl, _), ng = _port(pcfg, pparams, batch, "none")
    assert float(nl) == float(pl)
    for (k, a), (_, b) in zip(_flat(ng), _flat(pg)):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=str(k))


class _Count(TorchDispatchMode):
    """Counts the aten ops run under it, by overload packet."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_recomputes_all_but_the_unbatched_products(arch):
    """The ops the backward runs: under "dots" as many ``mm`` as without
    remat (the products' outputs were kept, none recomputed) and fewer
    than under "full" (which recomputes them), but more ops in all than
    without remat (the rest is recomputed)."""
    _, pcfg, _, pparams = _setup(arch)
    batch = pt_ts.batch_to(_batch(arch), "cpu")
    ops = {}
    for remat in ("none", "dots", "full"):
        pp = tree.tree_map(lambda a: a.clone().requires_grad_(True),
                           pparams)
        loss, _ = pt_ts.make_loss_fn(pcfg.replace(remat=remat))(pp, batch)
        with _Count() as count:
            loss.backward()
        ops[remat] = count.ops
    assert ops["dots"]["mm"] == ops["none"]["mm"] < ops["full"]["mm"], ops
    assert sum(ops["none"].values()) < sum(ops["dots"].values()) < \
        sum(ops["full"].values())


def test_an_unknown_remat_is_refused():
    _, pcfg, _, pparams = _setup("mingru-lm")
    with pytest.raises(ValueError, match="dots"):
        _port(pcfg, pparams, _batch("mingru-lm"), "some")
