"""Port parity for mesh-sharded serving (the port of
``tests/test_mesh_serving.py``, one counterpart per case).

The port serves a ``data x model`` mesh as a world of one process per
rank (``distributed/serve_mesh.py``).  Each mesh shape's scenarios run in
one CPU world of gloo ranks (``tests/torch_mesh_ranks.py``, spawned once
per shape); the JAX references run here, on the virtual CPU devices
``tests/conftest.py`` forces.  The contract, as the reference's:

  * pure DP (``Dx1``): per-row arithmetic is untouched, so greedy streams
    equal the single-device engine's -- the port's and JAX's, and JAX's
    own mesh streams -- token for token;
  * TP (``model > 1``): the split down projection reorders the fp32 sum,
    so streams are argmax-equal; they equal JAX's TP streams here, and
    one sharded ``decode_step`` holds JAX's single-device logits to
    2e-5;
  * the slot-step identity holds per shard and globally, and under TP
    the model ranks drain bit-equal planes.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import archs as jax_archs
from repro.distributed import serve_mesh as jax_serve_mesh
from repro.models import lm as jax_lm
from repro.serving import engine as jax_engine
from repro_torch import bridge
from repro_torch.configs import archs
from repro_torch.distributed import serve_mesh
from repro_torch.serving.engine import COMPLETED, ServingEngine
from repro_torch.serving.scheduler import ShardStats

import torch_mesh_ranks as ranks

pytestmark = pytest.mark.slow


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = jax_archs.smoke("mingru-lm")
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, pparams


@functools.lru_cache(maxsize=None)
def _world(mesh: str):
    """Every rank's results of this mesh shape's scenarios."""
    fn = ranks.tp_world if serve_mesh.MeshPlan.parse(mesh).model > 1 \
        else ranks.dp_world
    return serve_mesh.run_world(fn, serve_mesh.MeshPlan.parse(mesh).size,
                                (_pair()[2], mesh))


@functools.lru_cache(maxsize=None)
def _jax_streams(mesh, n_req=9, temperature=0.0, seed=0):
    """The JAX engine's streams under the reference tests' traffic."""
    jcfg, jparams, _ = _pair()
    eng = jax_engine.ServingEngine(jcfg, jparams, max_batch=4, max_len=96,
                                   decode_block=4, mesh=mesh, seed=seed)
    rng = np.random.RandomState(7)
    for _ in range(n_req):
        p = rng.randint(1, jcfg.vocab_size,
                        size=rng.randint(3, 12)).tolist()
        eng.submit(p, max_new=10 if temperature else 8,
                   temperature=temperature)
    out = eng.run_to_completion()
    return out, [dataclasses.asdict(s) for s in eng.stats.shards]


@functools.lru_cache(maxsize=None)
def _port_single(n_req=9):
    return ranks.run(_pair()[2], None, n_req=n_req)[0]


def _all_ranks_agree(results, key):
    """Every rank drained the same streams, with no plane mismatch."""
    first = results[0][key]["streams"]
    for r in results:
        assert r[key]["streams"] == first
        assert r[key]["stats"]["tp_plane_mismatches"] == 0
    return first


# ---------------------------------------------------------------------------
# MeshPlan surface
# ---------------------------------------------------------------------------

def test_mesh_plan_parse():
    assert serve_mesh.MeshPlan.parse(None) is None
    p = serve_mesh.MeshPlan.parse("4x2")
    assert (p.data, p.model, p.size, str(p)) == (4, 2, 8, "4x2")
    assert serve_mesh.MeshPlan.parse(p) is p
    for bad in ("4", "x2", "2x2x2", "ax1", "2*2", ""):
        with pytest.raises(ValueError):
            serve_mesh.MeshPlan.parse(bad)
        with pytest.raises(ValueError):
            jax_serve_mesh.MeshPlan.parse(bad)
    with pytest.raises(ValueError):
        serve_mesh.MeshPlan(0, 1)


def test_mesh_plan_build_too_many_devices_actionable():
    """Outside a world of its size a plan refuses, naming the launcher's
    ``--mesh`` and ``torchrun``; so does an engine asked for it."""
    for plan in (serve_mesh.MeshPlan(1024, 1), serve_mesh.MeshPlan(2, 1)):
        with pytest.raises(RuntimeError, match="torchrun") as e:
            plan.build()
        assert f"--mesh {plan}" in str(e.value)
    cfg, params = archs.smoke("mingru-lm"), _pair()[2]
    with pytest.raises(RuntimeError, match="not initialised"):
        ServingEngine(cfg, params, max_batch=4, mesh="2x1", device="cpu")


def test_engine_validates_mesh():
    cfg, params = archs.smoke("mingru-lm"), _pair()[2]
    with pytest.raises(ValueError, match="divide over the data"):
        ServingEngine(cfg, params, max_batch=3, mesh="2x1", device="cpu")
    # d_hidden = 128 on the smoke config: model=3 does not divide it
    with pytest.raises(ValueError, match="does not divide"):
        ServingEngine(cfg, params, max_batch=3, mesh="1x3", device="cpu")
    gemma = archs.smoke("gemma-2b")
    with pytest.raises(ValueError, match="requires block_kind='minrnn'"):
        ServingEngine(gemma, None, max_batch=2, mesh="1x2", device="cpu")


def test_one_by_one_mesh_serves_in_one_process():
    """``mesh="1x1"`` needs no world: one process, one shard, the
    meshless engine's streams."""
    out, eng = ranks.run(_pair()[2], "1x1")
    assert eng.mesh.rank == 0 and eng.mesh.model_group is None
    assert out == _port_single()
    assert len(eng.stats.shards) == 1 and eng.stats.shard_identities_ok()


# ---------------------------------------------------------------------------
# DP parity: bit-exact greedy streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["2x1", "4x1"])
def test_dp_greedy_bit_exact(mesh):
    results = _world(mesh)
    out = _all_ranks_agree(results, "greedy")
    ref = _port_single()
    assert out == ref
    assert out == _jax_streams(None)[0] == _jax_streams(mesh)[0]
    assert results[0]["greedy"]["completed"] == len(ref)
    assert all(r["greedy"]["stats"]["identities_ok"] for r in results)


def test_dp_speculative_bit_exact():
    """Drafting under a DP mesh never changes content, and drafts are
    accepted (the speculative path really ran)."""
    results = _world("2x1")
    out = _all_ranks_agree(results, "spec")
    assert out == _port_single() == _jax_streams(None)[0]
    assert results[0]["spec"]["accepted"] > 0
    assert results[0]["spec"]["stats"]["identities_ok"]


def test_dp_sampled_determinism_and_single_row_parity():
    """Sampling keys are per global row: a run repeats given (mesh,
    seed) and equals JAX's on that mesh, and a single request lands on
    row 0 under every shape, where the streams equal the one-device
    engine's -- and JAX's."""
    two, four = _world("2x1")[0], _world("4x1")[0]
    assert two["sampled_6"][0] == two["sampled_6"][1]
    # placed as the reference's stager places them: JAX's 2x1 streams
    assert two["sampled_6"][0] == _jax_streams("2x1", n_req=6,
                                               temperature=0.8, seed=11)[0]
    single = ranks.sampled(_pair()[2], None, 1)
    assert single == two["sampled_1"] == four["sampled_1"]
    assert single == _jax_streams(None, n_req=1, temperature=0.8,
                                  seed=11)[0]


# ---------------------------------------------------------------------------
# TP parity: argmax-equal streams, close logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_tp_greedy_streams(mesh):
    results = _world(mesh)
    out = _all_ranks_agree(results, "greedy")
    ref = _jax_streams(mesh, n_req=6)[0]
    assert set(out) == set(ref)
    for rid in ref:
        assert out[rid] == ref[rid], \
            f"rid {rid}: TP stream diverged from JAX's TP stream"
    assert out == _port_single(n_req=6)
    plan = serve_mesh.MeshPlan.parse(mesh)
    d_hidden = archs.smoke("mingru-lm").d_model * 2
    for r in results:
        g = r["greedy"]
        assert g["tier"] == "cell-fused"
        assert g["h_block"][1:] == (4 // plan.data, d_hidden // plan.model)
        assert g["stats"]["identities_ok"]


def test_tp_logits_close():
    """One sharded ``decode_step`` (1x2) reproduces JAX's single-device
    logits to the fp32 reduction-order tolerance, on both model ranks
    bit for bit."""
    jcfg, jparams, _ = _pair()
    cache = jax_lm.init_cache(jcfg, 2, 32)
    ref, _ = jax.jit(lambda p, t, c: jax_lm.decode_step(p, jcfg, t, c))(
        jparams, np.asarray([3, 5], np.int32), cache)
    results = _world("1x2")
    np.testing.assert_array_equal(results[0]["logits"], results[1]["logits"])
    np.testing.assert_allclose(results[0]["logits"], np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# Per-shard accounting
# ---------------------------------------------------------------------------

def test_shard_stats_identity_and_aggregation():
    stats = _world("4x1")[0]["greedy"]["stats"]
    shards, snap = stats["shards"], stats["snapshot"]
    assert len(shards) == 4
    assert stats["identities_ok"]
    for key in ("slot_steps", "decode_tokens", "prefill_rounds",
                "wasted_slot_steps", "non_spec_tokens"):
        assert sum(s[key] for s in shards) == snap[key]
    assert snap["n_shards"] == 4 and snap["shard_identities_ok"]
    # the stager places and the counters land as the reference's, shard
    # for shard
    assert shards == _jax_streams("4x1")[1]


def test_wasted_slot_steps_land_on_the_idle_shard():
    """One long request pins shard 0 while shard 1 sits empty: the idle
    shard accrues the wasted slot-steps, the busy one the work."""
    stats = _world("2x1")[0]["idle_shard"]
    s0, s1 = (ShardStats(**s) for s in stats["shards"])
    assert s0.decode_tokens == 12 and s1.decode_tokens == 0
    assert s1.wasted_slot_steps == s1.slot_steps
    assert s0.wasted_slot_steps < s0.slot_steps
    assert stats["identities_ok"]


def test_stager_balances_shards():
    """Two concurrent requests land on different shards."""
    s0, s1 = _world("2x1")[0]["balance"]["shards"]
    assert s0["decode_tokens"] == 6 and s1["decode_tokens"] == 6


def test_cancel_and_deadline_on_nonzero_shard():
    """Cancel an in-flight request on shard 1 and time one out there;
    partial output survives and the identities hold."""
    w = _world("2x1")[0]
    assert w["cancel_slot"] >= 2 and w["cancelled"]
    assert w["cancel"]["status"] == [COMPLETED, "CANCELLED"]
    assert 0 < w["cancel"]["len_r1"] < 40
    assert w["cancel"]["stats"]["identities_ok"]
    assert w["deadline_slot"] >= 2
    assert w["deadline"]["slot_after"] is None
    assert w["deadline"]["status"] == [COMPLETED, "TIMED_OUT"]
    assert w["deadline"]["stats"]["identities_ok"]


def test_shard_stats_identity_definition():
    s = ShardStats(slot_steps=10, prefill_rounds=4, decode_tokens=5,
                   first_tokens=2, wasted_slot_steps=3,
                   nonfinite_decode_rounds=0, non_spec_tokens=5)
    assert s.identity_ok()
    s.wasted_slot_steps = 2
    assert not s.identity_ok()


def test_meshless_engine_has_single_shard():
    out, eng = ranks.run(_pair()[2], None, n_req=5)
    assert len(eng.stats.shards) == 1
    st = eng.stats
    assert st.shards[0].slot_steps == st.slot_steps
    assert st.shard_identities_ok()
    assert len(out) == 5


# ---------------------------------------------------------------------------
# Placements against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2", "1x4"])
def test_serve_param_placements_match_the_reference(mesh):
    """``serve_params_pspecs`` places every leaf of the smoke params as
    the reference's does, and ``shard_params`` cuts contiguous blocks
    whose concatenation is the whole leaf."""
    from jax.sharding import PartitionSpec as P
    from repro_torch.tree import leaves_with_path
    jcfg, jparams, pparams = _pair()
    plan = serve_mesh.MeshPlan.parse(mesh)
    jmesh = jax.make_mesh((plan.data, plan.model), ("data", "model"))
    jspecs = jax_serve_mesh.serve_params_pspecs(jparams, jcfg, plan, jmesh)
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, P))[0]:
        want[tuple(p.key for p in path)] = tuple(spec)
    cfg = archs.smoke("mingru-lm")
    split = 0
    for r in range(plan.size):
        rank = serve_mesh.RankMesh(plan, r)
        specs = serve_mesh.serve_params_pspecs(pparams, cfg, rank)
        local = serve_mesh.shard_params(pparams, cfg, rank)
        for path, leaf in leaves_with_path(pparams):
            got = _get(specs, path)
            w = want[path]
            assert got == w + (None,) * (len(got) - len(w)), path
            block = _get(local, path)
            if any(g is not None for g in got):
                split += 1
                assert block.is_contiguous() and \
                    block.data_ptr() != leaf.data_ptr()
                dim = next(i for i, g in enumerate(got) if g is not None)
                assert block.shape[dim] * plan.model == leaf.shape[dim]
                idx = rank.model_index * block.shape[dim]
                torch.testing.assert_close(
                    block, leaf.narrow(dim, idx, block.shape[dim]),
                    rtol=0, atol=0)
            else:
                assert block is leaf
    assert (split > 0) == (plan.model > 1)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_launcher_serves_a_mesh_and_fails_with_a_rank(capfd):
    """``launch/serve.py --mesh``: rank 0 prints the mesh line with the
    identities true and every rank's device; a rank that raises makes the
    launcher raise (a non-zero exit)."""
    from torch.multiprocessing import ProcessRaisedException

    from repro_torch.launch import serve
    serve.main(["--smoke", "--device", "cpu", "--mesh", "2x2",
                "--max-new", "4", "--decode-block", "2"])
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("mesh 2x2")]
    assert len(lines) == 1
    assert "rank devices cpu, cpu, cpu, cpu" in lines[0]
    assert "slot-step identity per shard + global: True" in lines[0]
    assert "plane mismatches: 0" in lines[0]
    with pytest.raises(ProcessRaisedException, match="does not divide"):
        serve.main(["--smoke", "--device", "cpu", "--mesh", "1x3"])
