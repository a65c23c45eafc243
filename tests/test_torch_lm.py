"""Port parity for the LM decode path and the param bridge.

JAX smoke params (``lm.init_params``) are bridged into the port, and the
same token streams go through ``decode_step`` / ``decode_chunk`` of both
packages.  The JAX side runs its block kernel in interpret mode, the port
its plain PyTorch version (CPU tensors).  Tolerance: fp32 at atol = rtol
= 1e-5 (same arithmetic, matmuls summed in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.models import lm as jax_lm
from repro_torch import bridge, tree
from repro_torch.configs import archs as pt_archs
from repro_torch.models import lm as pt_lm

ARCHS = ("mingru-lm", "minlstm-lm")
TOL = 1e-5


def _pair(arch):
    jcfg = jax_archs.smoke(arch)
    pcfg = pt_archs.smoke(arch)
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, pcfg, jparams, pparams


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.float().numpy(), rtol=TOL, atol=TOL)


def test_port_config_matches_reference():
    for arch in ARCHS + ("gemma-2b-mingru",):
        for get in ("get", "smoke"):
            j = getattr(jax_archs, get)(arch)
            p = getattr(pt_archs, get)(arch)
            for f in ("block_kind", "seq_mixer", "n_layers", "d_model",
                      "d_ff", "vocab_size", "norm", "norm_zero_centered",
                      "gated_mlp", "mlp_activation", "mlp_bias",
                      "embedding_scale", "tie_embeddings", "param_dtype",
                      "compute_dtype", "padded_vocab"):
                assert getattr(j, f) == getattr(p, f), (arch, get, f)
            for f in ("cell", "expansion", "mode", "use_conv",
                      "conv_kernel", "use_mlp"):
                assert getattr(j.minrnn, f) == getattr(p.minrnn, f)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_jax(arch):
    jcfg, pcfg, jparams, pparams = _pair(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, size=(6, 3)).astype(np.int32)
    jc = jax_lm.init_cache(jcfg, 3, 32)
    pc = pt_lm.init_cache(pcfg, 3, 32, device="cpu")
    step = jax.jit(lambda p, t, c: jax_lm.decode_step(p, jcfg, t, c))
    for t in toks:
        jl, jc = step(jparams, jnp.asarray(t), jc)
        pl, pc = pt_lm.decode_step(pparams, pcfg, torch.from_numpy(t), pc)
        _close(jl, pl)
    _close(jc["h"], pc["h"])
    _close(jc["conv"], pc["conv"])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), pc["pos"].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chunk_logits_match_jax(arch):
    jcfg, pcfg, jparams, pparams = _pair(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, size=(3, 4)).astype(np.int32)
    valid = np.asarray([4, 2, 1], np.int32)
    jl, jc = jax.jit(lambda p, t, v, c: jax_lm.decode_chunk(
        p, jcfg, t, v, c))(jparams, jnp.asarray(toks), jnp.asarray(valid),
                           jax_lm.init_cache(jcfg, 3, 32))
    pl, pc = pt_lm.decode_chunk(pparams, pcfg, torch.from_numpy(toks),
                                torch.from_numpy(valid),
                                pt_lm.init_cache(pcfg, 3, 32, device="cpu"))
    _close(jl, pl)
    _close(jc["h"], pc["h"])
    _close(jc["conv"], pc["conv"])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), pc["pos"].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips(dtype):
    cfg = jax_archs.smoke("mingru-lm").replace(param_dtype=dtype)
    jparams = jax.tree.map(np.asarray,
                           jax_lm.init_params(jax.random.PRNGKey(3), cfg))
    pparams = bridge.params_from_jax(jparams, device="cpu")
    want_dt = torch.float32 if dtype == "float32" else torch.bfloat16
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(tree.leaves(pparams))
    for path, leaf in flat_j:
        t = pparams
        for k in path:
            t = t[k.key]
        assert t.dtype == want_dt and tuple(t.shape) == leaf.shape
        if dtype == "bfloat16":       # bit for bit
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                leaf.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), leaf)
    back = bridge.params_to_numpy(pparams)
    np.testing.assert_array_equal(
        back["embed"]["table"], np.asarray(jparams["embed"]["table"],
                                           np.float32))


def test_minrnn_lm_module_holds_params():
    _, pcfg, _, pparams = _pair("mingru-lm")
    model = pt_lm.MinRNNLM(pcfg, pparams)
    sd = model.state_dict()
    assert "tree.layers.blocks.rnn.wz.kernel" in sd
    again = model.params()
    assert torch.equal(again["layers"]["blocks"]["down"]["kernel"],
                       pparams["layers"]["blocks"]["down"]["kernel"])
