"""The reference's small public names the port keeps as copies without
JAX (``tests/test_torch_coverage.py`` finds them by name; these hold
their values): the minRNN cells' parameter counts (the paper's claim
(1), fewer parameters than GRU / LSTM), ``scan.scan_step``,
``mlp.mlp_flops``, ``archs.ASSIGNED`` / ``EXTRAS`` and
``base.SHAPES`` / ``ShapeConfig`` / ``SUBQUADRATIC_KINDS`` /
``long_context_ok``, each against the reference's.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.configs import base as jax_base
from repro.core import min_gru as jax_min_gru
from repro.core import min_lstm as jax_min_lstm
from repro.core import scan as jax_scan
from repro.models import mlp as jax_mlp
from repro_torch import tree
from repro_torch.configs import archs as pt_archs
from repro_torch.configs import base as pt_base
from repro_torch.core import gru as pt_gru
from repro_torch.core import lstm as pt_lstm
from repro_torch.core import min_gru as pt_min_gru
from repro_torch.core import min_lstm as pt_min_lstm
from repro_torch.core import scan as pt_scan
from repro_torch.models import mlp as pt_mlp

CELLS = {"mingru": (jax_min_gru, pt_min_gru, pt_gru),
         "minlstm": (jax_min_lstm, pt_min_lstm, pt_lstm)}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_min_cell_n_params_count_init_and_match_the_reference(cell, bias):
    jm, pm, rival = CELLS[cell]
    for dx, dh in ((24, 40), (64, 64), (768, 1536), (2048, 2048)):
        assert pm.n_params(dx, dh, bias) == jm.n_params(dx, dh, bias)
        assert pm.n_params(dx, dh, bias) < rival.n_params(dx, dh, bias)
    own = pm.init(torch.Generator().manual_seed(0), 24, 40, use_bias=bias)
    assert sum(a.numel() for a in tree.leaves(own)) == \
        pm.n_params(24, 40, bias)


def test_scan_step_matches_the_reference_and_the_sequential_scan():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(0, 1, (2, 5, 3)), rng.standard_normal((2, 5, 3))
    a, b = a.astype(np.float32), b.astype(np.float32)
    h = np.zeros((2, 3), np.float32)
    ht = torch.zeros((2, 3))
    for t in range(5):
        h = np.asarray(jax_scan.scan_step(jnp.asarray(a[:, t]),
                                          jnp.asarray(b[:, t]),
                                          jnp.asarray(h)))
        ht = pt_scan.scan_step(torch.from_numpy(a[:, t]),
                               torch.from_numpy(b[:, t]), ht)
        np.testing.assert_allclose(ht.numpy(), h, rtol=1e-6, atol=1e-6)
    seq = pt_scan.scan_sequential(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(seq[:, -1], ht)


@pytest.mark.parametrize("gated", [False, True])
def test_mlp_flops_match_the_reference(gated):
    for d, f in ((64, 256), (2048, 16384), (7168, 18432)):
        assert pt_mlp.mlp_flops(d, f, gated) == jax_mlp.mlp_flops(d, f, gated)


def test_arch_lists_shapes_and_long_context_match_the_reference():
    assert pt_archs.ASSIGNED == jax_archs.ASSIGNED
    assert pt_archs.EXTRAS == jax_archs.EXTRAS
    assert pt_archs.PAPER_OWN == jax_archs.PAPER_OWN
    assert set(pt_archs.ASSIGNED + pt_archs.EXTRAS + pt_archs.PAPER_OWN) \
        == set(pt_archs.all_names())
    assert pt_base.SUBQUADRATIC_KINDS == jax_base.SUBQUADRATIC_KINDS
    assert {k: dataclasses.asdict(v) for k, v in pt_base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_base.SHAPES.items()}
    for name in jax_archs.all_names():
        for mixer in ("native", "mingru", "minlstm"):
            j = jax_archs.get(name).replace(seq_mixer=mixer)
            p = pt_archs.get(name).replace(seq_mixer=mixer)
            assert pt_base.long_context_ok(p) == \
                jax_base.long_context_ok(j), (name, mixer)
