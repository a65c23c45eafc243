"""Port of the serving engine's tune plans: ``serving/tuning.py`` and the
autotuner ``serving/autotune.py``.

A plan names the device it was measured on, so the JAX package's
CPU-modelled plans at the repo root are never picked up by ``"auto"`` and
raise when passed by path; discovery follows the reference's order; the
plan fills K, C and the decode tier only where the caller left them
open; and an engine serving under a plan streams as the JAX engine does
under the same K / C / ``fuse_block`` (same bridged weights, exact).
"""

from __future__ import annotations

import functools
import json

import jax
import numpy as np
import pytest

from repro.configs import archs as jax_archs
from repro.models import lm as jax_lm
from repro.serving import engine as jax_engine
from repro_torch import bridge
from repro_torch.configs import archs
from repro_torch.serving import autotune, tuning
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.engine import replay_trace as pt_replay

MAX_LEN = 64


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = jax_archs.smoke("mingru-lm")
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, archs.smoke("mingru-lm"), jparams, pparams


def _plan(cfg, **kw):
    plan = {"config": tuning.config_stamp(cfg, "cpu"), "fuse_block": "off",
            "decode_block": 4, "prompt_chunk": 4}
    plan.update(kw)
    return plan


def test_plan_file_names_the_device():
    cfg = archs.smoke("mingru-lm")
    assert tuning.tune_filename(cfg, "cpu") == "TUNE_mingru-lm_L3_d64_cpu.json"
    assert tuning.device_slug("NVIDIA H100 80GB HBM3") == \
        "nvidia-h100-80gb-hbm3"
    assert tuning.config_stamp(cfg, "cpu")["device"] == "cpu"


def test_discovery_order(tmp_path, monkeypatch):
    cfg = archs.smoke("mingru-lm")
    name = tuning.tune_filename(cfg, "cpu")
    dirs = {k: tmp_path / k for k in ("env", "cwd", "root")}
    for i, d in enumerate(dirs.values()):
        d.mkdir()
        tuning.save_plan(d / name, _plan(cfg, decode_block=i + 1))
    monkeypatch.setattr(tuning, "_REPO_ROOT", dirs["root"])
    monkeypatch.chdir(dirs["cwd"])
    monkeypatch.setenv("REPRO_TUNE_DIR", str(dirs["env"]))
    assert [p.parent for p in tuning.search_paths(cfg, "cpu")] == \
        [dirs["env"], dirs["cwd"], dirs["root"]]
    assert tuning.resolve_plan(cfg, "auto", "cpu")["decode_block"] == 1
    (dirs["env"] / name).unlink()
    got = tuning.resolve_plan(cfg, "auto", "cpu")
    assert got["decode_block"] == 2 and got["source"] == \
        str(dirs["cwd"] / name)
    (dirs["cwd"] / name).unlink()
    assert tuning.resolve_plan(cfg, "auto", "cpu")["decode_block"] == 3
    # a plan for another device under the right name is skipped
    foreign = _plan(cfg)
    foreign["config"]["device"] = "NVIDIA H100 80GB HBM3"
    tuning.save_plan(dirs["env"] / name, foreign)
    assert tuning.resolve_plan(cfg, "auto", "cpu")["decode_block"] == 3
    monkeypatch.delenv("REPRO_TUNE_DIR")
    (dirs["root"] / name).unlink()
    assert tuning.resolve_plan(cfg, "auto", "cpu") is None


def test_auto_ignores_the_jax_packages_plans():
    """``TUNE_mingru-lm_L3_d64.json`` (the JAX package's, scored by a CPU
    model of a TPU) sits at the repo root: "auto" never finds it, and
    passing it by path raises with the mismatch."""
    jax_plan = tuning._REPO_ROOT / "TUNE_mingru-lm_L3_d64.json"
    assert jax_plan.is_file()
    cfg = archs.smoke("mingru-lm")
    assert tuning.resolve_plan(cfg, "auto", "cpu") is None
    with pytest.raises(ValueError, match="generated for"):
        tuning.resolve_plan(cfg, str(jax_plan), "cpu")
    assert tuning.resolve_plan(cfg, None, "cpu") is None


def test_path_mismatch_raises(tmp_path):
    cfg = archs.smoke("mingru-lm")
    path = tmp_path / "plan.json"
    tuning.save_plan(path, _plan(archs.smoke("minlstm-lm")))
    with pytest.raises(ValueError, match="minlstm-lm"):
        tuning.resolve_plan(cfg, str(path), "cpu")
    tuning.save_plan(path, _plan(cfg))
    assert tuning.resolve_plan(cfg, str(path), "cpu")["source"] == str(path)


def test_explicit_knobs_win_over_the_plan():
    _, cfg, _, params = _pair()
    plan = _plan(cfg, fuse_block="off", decode_block=8, prompt_chunk=4)
    eng = ServingEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                        device="cpu", tune=plan)
    assert (eng.decode_block, eng.prompt_chunk, eng.cfg.fuse_block) == \
        (8, 4, "off")
    assert eng.tune_plan is plan
    eng = ServingEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                        device="cpu", tune=plan, decode_block=2,
                        prompt_chunk=1, fuse_block="on")
    assert (eng.decode_block, eng.prompt_chunk, eng.cfg.fuse_block) == \
        (2, 1, "on")
    eng = ServingEngine(cfg, params, max_batch=2, max_len=MAX_LEN,
                        device="cpu")
    assert eng.tune_plan is None and eng.decode_block == 1


def test_autotune_two_points_writes_a_cpu_plan_that_auto_finds(
        tmp_path, monkeypatch):
    lines = []
    plan = autotune.sweep("mingru-lm", smoke=True, device="cpu", points=2,
                          n_requests=8, out_dir=tmp_path, log=lines.append)
    assert [(r["fuse_block"], r["prompt_chunk"], r["decode_block"])
            for r in plan["sweep"]] == [("on", 16, 1), ("on", 1, 1)]
    assert plan["device"] == "cpu" and plan["card"] is None
    assert plan["streams_identical_within_tier"]
    with open(plan["path"]) as f:
        on_disk = json.load(f)
    assert on_disk["config"]["device"] == "cpu"
    assert on_disk["decode_block"] == plan["decode_block"]
    monkeypatch.setenv("REPRO_TUNE_DIR", str(tmp_path))
    cfg = archs.smoke("mingru-lm")
    found = tuning.resolve_plan(cfg, "auto", "cpu")
    assert found["source"] == plan["path"]
    assert "wrote" in lines[-1]


def test_autotune_trace_is_the_reference_benchmarks(monkeypatch):
    monkeypatch.syspath_prepend(str(tuning._REPO_ROOT))
    from benchmarks import engine_throughput
    assert autotune.make_trace(48, 8) == engine_throughput.make_trace(48, 8)
    assert autotune.trace_prompt(5, 17) == \
        [int(t) for t in engine_throughput._trace_prompt(5, 17)]


@pytest.mark.parametrize("fuse_block,k,c", [("on", 4, 4), ("off", 8, 1),
                                            ("off", 2, 8)])
def test_planned_engine_streams_as_the_jax_engine(fuse_block, k, c):
    jcfg, pcfg, jparams, pparams = _pair()
    trace = autotune.make_trace(10, 3)
    plan = _plan(pcfg, fuse_block=fuse_block, decode_block=k,
                 prompt_chunk=c)

    def run(eng, replay_trace):
        rids = []
        replay_trace(eng, trace, lambda i, r: rids.append(eng.submit(
            autotune.trace_prompt(i, r["prompt_len"]),
            max_new=r["max_new"])))
        return [eng.finished[r].out for r in rids], eng.stats.decode_steps

    port = ServingEngine(pcfg, pparams, max_batch=3, max_len=96,
                         device="cpu", tune=plan)
    ref = jax_engine.ServingEngine(jcfg, jparams, max_batch=3, max_len=96,
                                   decode_block=k, prompt_chunk=c,
                                   fuse_block=fuse_block)
    assert port.kernel_tier == ref.kernel_tier
    assert run(port, pt_replay) == run(ref, jax_engine.replay_trace)
