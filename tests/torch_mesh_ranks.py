"""What each rank of a CPU serving world runs for the port's mesh tests
(``test_torch_mesh_serving.py``, ``test_torch_recovery.py``,
``test_torch_distributed_context.py``).

The tests start a world with ``serve_mesh.run_world(fn, size, args)``,
which spawns one process per rank; a rank imports this module by name,
so it imports torch and the port only -- no JAX, no test module.  Each
function runs every scenario of one mesh shape in one world (one spawn
per shape) and returns plain data: streams, stats and flags.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.configs import archs
from repro_torch.core import blocks
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import serve_mesh
from repro_torch.models import lm
from repro_torch.serving import recovery
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import FaultInjector

CFG = archs.smoke("mingru-lm")


def submit_all(eng, n, seed=7, max_new=8, temperature=0.0, **kw):
    """The reference tests' traffic: ``n`` prompts of 3..11 random tokens."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        p = rng.randint(1, CFG.vocab_size,
                        size=rng.randint(3, 12)).tolist()
        eng.submit(p, max_new=max_new, temperature=temperature, **kw)


def engine(params, mesh, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_len", 96)
    kw.setdefault("decode_block", 4)
    return ServingEngine(CFG, params, mesh=mesh, device="cpu", **kw)


def run(params, mesh, n_req=9, **kw):
    eng = engine(params, mesh, **kw)
    submit_all(eng, n_req)
    return eng.run_to_completion(), eng


def sampled(params, mesh, n):
    eng = engine(params, mesh, seed=11)
    submit_all(eng, n, max_new=10, temperature=0.8)
    return eng.run_to_completion()


def _stats(eng) -> dict:
    st = eng.stats
    return {"snapshot": {k: v for k, v in st.snapshot().items()},
            "shards": [dataclasses.asdict(s) for s in st.shards],
            "identities_ok": st.shard_identities_ok(),
            "tp_plane_mismatches": eng.tp_plane_mismatches}


def _cancel_and_deadline(params, mesh) -> dict:
    """The reference's cancel / deadline case on shard 1."""
    out = {}
    eng = engine(params, mesh, decode_block=2)
    r0 = eng.submit([5, 6, 7], max_new=40)
    r1 = eng.submit([8, 9, 10], max_new=40)            # -> shard 1
    eng.step()
    out["cancel_slot"] = eng.requests[r1].slot
    while not eng.requests[r1].out:
        eng.step()
    out["cancelled"] = eng.cancel(r1)
    streams = eng.run_to_completion()
    out["cancel"] = {"status": [eng.finished[r].status for r in (r0, r1)],
                     "len_r1": len(streams[r1]), "stats": _stats(eng)}
    eng2 = engine(params, mesh, decode_block=2)
    d0 = eng2.submit([5, 6, 7], max_new=40, deadline=500)
    d1 = eng2.submit([8, 9, 10], max_new=40, deadline=512)
    eng2.step()
    out["deadline_slot"] = eng2.requests[d1].slot
    eng2.requests[d1].deadline = eng2.stats.decode_steps
    eng2.run_to_completion()
    out["deadline"] = {
        "slot_after": eng2.requests[d1].slot,
        "status": [eng2.finished[r].status for r in (d0, d1)],
        "stats": _stats(eng2)}
    return out


def dp_world(params, mesh: str) -> dict:
    """Every data-parallel scenario of the reference's mesh tests at
    ``mesh`` ("2x1" or "4x1")."""
    out = {}
    streams, eng = run(params, mesh)
    out["greedy"] = {"streams": streams, "stats": _stats(eng),
                     "completed": eng.stats.completed}
    out["sampled_1"] = sampled(params, mesh, 1)
    if mesh == "4x1":
        return out
    streams, eng = run(params, mesh, speculative="ngram")
    out["spec"] = {"streams": streams, "stats": _stats(eng),
                   "accepted": eng.stats.draft_accepted}
    out["sampled_6"] = [sampled(params, mesh, 6) for _ in range(2)]
    eng = engine(params, mesh)
    eng.submit([5, 6, 7], max_new=12)
    eng.run_to_completion()
    out["idle_shard"] = _stats(eng)
    eng = engine(params, mesh, decode_block=2)
    eng.submit([5, 6, 7], max_new=6)
    eng.submit([8, 9], max_new=6)
    eng.run_to_completion()
    out["balance"] = _stats(eng)
    out.update(_cancel_and_deadline(params, mesh))
    return out


def tp_world(params, mesh: str) -> dict:
    """The tensor-parallel scenarios at ``mesh`` ("1x2" or "2x2"): greedy
    streams, the engine's tier, and at ``1x2`` one sharded
    ``decode_step``'s logits (tokens [3, 5] from an empty cache)."""
    streams, eng = run(params, mesh, n_req=6)
    out = {"greedy": {"streams": streams, "stats": _stats(eng),
                      "tier": eng.kernel_tier,
                      "h_block": tuple(eng.state["cache"]["h"].shape)}}
    if mesh == "1x2":
        rank_mesh = serve_mesh.MeshPlan.parse(mesh).build()
        local = serve_mesh.shard_params(params, CFG, rank_mesh)
        cache = serve_mesh.cut_slot_state(
            CFG, {"cache": lm.init_cache(CFG, 2, 32, "cpu")},
            rank_mesh)["cache"]
        toks = torch.tensor([3, 5], dtype=torch.int32)
        with mesh_ctx.serving_tp(rank_mesh.model_group):
            logits, _ = lm.decode_step(local, CFG, toks, cache)
        out["logits"] = logits.numpy()
    return out


def recovery_world(params, tmp: str) -> dict:
    """The reference's two meshed recovery cases at 2x1, and a meshed
    kill / restore through the journal (rank 0 writes it)."""
    out = {}

    def mesh_run(faults=None):
        eng = ServingEngine(CFG, params, max_batch=4, max_len=64,
                            decode_block=2, mesh="2x1", faults=faults,
                            device="cpu")
        rids = [eng.submit([i + 1, i + 2, i + 3], max_new=5)
                for i in range(6)]
        return eng, rids, eng.run_to_completion()

    ref_eng, rids, ref = mesh_run()
    eng, rids2, outs = mesh_run(FaultInjector(shard_crash_at=((4, 1),)))
    out["failover"] = {
        "rids_equal": rids2 == rids,
        "crash_count": eng.faults.counts()["shard_crash"],
        "dead_shards": sorted(eng.dead_shards),
        "shard_crashes": eng.stats.shard_crashes,
        "failover_requeued": eng.stats.failover_requeued,
        "retried": eng.stats.retried,
        "statuses": [eng.finished[r].status for r in rids],
        "streams": [outs[r] for r in rids],
        "ref_streams": [ref[r] for r in rids],
        "completed": eng.stats.completed, "submitted": eng.stats.submitted,
        "identities_ok": eng.stats.snapshot()["shard_identities_ok"],
        "report_dead": eng.occupancy_report()["dead_shards"],
        "rounds": eng.stats.decode_steps,
        "ref_rounds": ref_eng.stats.decode_steps}

    def crashed():
        return ServingEngine(CFG, params, max_batch=4, max_len=64,
                             decode_block=2, mesh="2x1", device="cpu",
                             faults=FaultInjector(shard_crash_at=((2, 1),)))
    eng = crashed()
    [eng.submit([i + 1, i + 2], max_new=6) for i in range(5)]
    for _ in range(3):
        eng.step()
    dead_before = sorted(eng.dead_shards)
    arrays, manifest = recovery.snapshot_engine(eng)
    manifest = json.loads(json.dumps(manifest, default=recovery._np_item))
    clone = crashed()
    recovery.apply_snapshot(clone, arrays, manifest)
    out["roundtrip"] = {
        "dead_before": dead_before,
        "clone_dead": sorted(clone.dead_shards),
        "clone_crashed": sorted(clone.faults._crashed_shards),
        "h_shape": tuple(arrays["state|cache|h"].shape),
        "orig": eng.run_to_completion(), "clone": clone.run_to_completion(),
        "rounds": (eng.stats.decode_steps, clone.stats.decode_steps)}

    # a journaled meshed run abandoned after 5 steps, restored from its
    # directory on every rank, finishes as an uninterrupted run does
    d = os.path.join(tmp, "journal")
    kw = dict(max_batch=4, max_len=64, decode_block=2, mesh="2x1",
              device="cpu", snapshot_every=4)
    full = ServingEngine(CFG, params, **kw)
    killed = ServingEngine(CFG, params, recover_dir=d, **kw)
    for e in (full, killed):
        [e.submit([i + 3, i + 1], max_new=7, temperature=0.5 * (i % 2))
         for i in range(7)]
    for _ in range(5):
        killed.step()
    restored = ServingEngine.restore(d, CFG, params, device="cpu")
    out["restore"] = {
        "report": {k: restored.recovery_report[k] for k in
                   ("snapshot_round", "replayed_records")},
        "restored": restored.run_to_completion(),
        "full": full.run_to_completion(),
        "rounds": (restored.stats.decode_steps, full.stats.decode_steps),
        "writer": restored.writer,
        "journal_exists": os.path.exists(
            os.path.join(d, recovery.JOURNAL_NAME))}
    return out


def row_parallel_world(full: np.ndarray, bias: np.ndarray,
                       x: np.ndarray) -> dict:
    """``blocks._row_parallel_apply`` on a 2-rank model group: each rank
    holds a row block of the kernel and the matching column block of x;
    also a whole kernel under the context, and no context."""
    mesh = serve_mesh.MeshPlan(1, 2).build()
    i, half = mesh.model_index, full.shape[0] // 2
    k = torch.from_numpy(full)
    b = torch.from_numpy(bias)
    xt = torch.from_numpy(x)
    part = {"kernel": k[i * half:(i + 1) * half].contiguous(), "bias": b}
    xs = xt[:, i * half:(i + 1) * half].contiguous()
    with mesh_ctx.serving_tp(mesh.model_group):
        sharded = blocks._row_parallel_apply(part, xs, None, full.shape[0])
        listed = blocks._row_parallel_apply(part, [xs, 2 * xs], None,
                                            full.shape[0])
        whole = blocks._row_parallel_apply({"kernel": k, "bias": b}, xt,
                                           None, full.shape[0])
    plain = blocks._row_parallel_apply(part, xs, None, full.shape[0])
    return {"sharded": sharded.numpy(), "listed": [t.numpy() for t in listed],
            "whole": whole.numpy(), "no_context": plain.numpy()}


def card_world(mesh: str, dtype: str) -> dict:
    """One rank of a world on the card (every rank on ``cuda:0`` on one
    card): the smoke LM in ``dtype``, weights drawn on the card from one
    seed, the reference tests' traffic at K 4 on the config's tier."""
    from repro_torch.kernels.block_step import ops as block_ops
    from repro_torch.kernels.decode_step import ops as step_ops
    dev = serve_mesh.rank_device("cuda")
    cfg = CFG.replace(param_dtype=dtype, compute_dtype=dtype)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    block_ops.reset_launches()
    step_ops.reset_launches()
    eng = ServingEngine(cfg, params, max_batch=4, max_len=96,
                        decode_block=4, mesh=mesh, device=dev)
    submit_all(eng, 9)
    out = eng.run_to_completion()
    launches = dict(block_ops.LAUNCHES)
    launches.update(step_ops.LAUNCHES)
    return {"streams": out, "tier": eng.kernel_tier, "device": str(dev),
            "rounds": eng.stats.decode_steps, "launches": launches,
            "mismatches": eng.tp_plane_mismatches,
            "identities_ok": eng.stats.shard_identities_ok()}
