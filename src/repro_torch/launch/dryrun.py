"""Multi-pod dry run (the port of ``repro.launch.dryrun``).

Traces every (architecture x input-shape x mesh) cell of the production
mesh (``launch/mesh.py``: 16x16 = 256 ranks, or 2x16x16 = 512 with the
pod axis folded into the data ranks, as ``context.dp_axes`` does) without
allocating anything.  One process plays one rank of a fake world (the
``"fake"`` process-group backend: every collective returns at once) and
runs the port's own step for that rank on fake tensors (``FakeTensorMode``)
on ``--device`` (the card's ``cuda`` by default: the kernels' wrappers
take their shape-only route there; ``cpu`` runs the plain versions):

  * train: ``train_step.make_mesh_train_step`` on the rank's blocks of
    the params and AdamW moments under ``moe.expert_placements`` of
    ``moe.ep_layout`` (the routed experts split over ``model``, in 2D
    also over ``data``; every other leaf whole), on the global batch,
    whose rows the step splits over the data ranks;
  * prefill: ``lm.prefill`` / ``encdec.prefill`` on the rank's rows, the
    params whole;
  * decode: ``lm.decode_step`` / ``encdec.decode_step`` on the rank's
    rows of the cache (``serve_mesh.cut_slot_state``), inside
    ``serving_tp`` of the model group with the minRNN serving
    projections split over ``model`` (``serve_mesh.shard_params``) where
    the serving engine splits them (a minRNN LM whose d_hidden the model
    axis divides); else the params whole and the model ranks repeating
    the row's work.  Rows the data axis does not divide are whole on
    every rank (``sharding.token_pspec``'s rule).

On one rank (a 1x1 mesh) there is no world: the train step is
``make_train_step``, the port's one-card step.

Each cell records the reference's keys -- ``hbm_per_device`` (the peak of
the step's live storages: arguments, gradients, optimizer moments and
transient gathers), ``flops_per_dev`` (``FlopCounterMode``'s count of the
ops plus the kernels' recorded FLOPs), ``bytes_per_dev`` (each op's and
kernel call's inputs read and outputs written once), ``collectives``
(``hlo_analysis.collective_stats``), ``roofline`` (H100 data sheet
constants), ``n_params`` / ``n_params_active``, ``model_flops``,
``useful_flops_ratio`` -- and ``fits`` (``hbm_per_device`` against the
card's 80 GB) and ``kernels`` (launches and work of each kernel of the
repo the step calls).  Eager tracing counts every layer, so the
reference's depth extrapolation has no counterpart.

  python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --out build/dryrun/dryrun.jsonl --jobs 8

``--all`` orchestrates one subprocess per cell (isolation +
resumability; ``--jobs`` of them at a time).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.configs import archs
from repro_torch.configs.base import SHAPES, long_context_ok
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import serve_mesh, sharding
from repro_torch.kernels import launch as kl
from repro_torch.launch import hlo_analysis, input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import encdec, lm
from repro_torch.models import moe as moe_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_step as ts_lib
from repro_torch.tree import at, map_with_path


def _opt_cfg(cfg):
    return opt_lib.AdamWConfig(
        moment_dtype="bfloat16" if cfg.param_dtype == "bfloat16"
        else "float32")


@contextlib.contextmanager
def fake_world(mesh):
    """Rank 0 of a fake world of the mesh's size, open inside the block
    (none for one rank).  A fake world already open is closed first; a
    real one refuses."""
    import torch.distributed as dist
    n = math.prod(mesh.sizes)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry run plays a rank of a fake world; this process "
                f"has a {dist.get_backend()} world open")
        serve_mesh.forget_groups()
        dist.destroy_process_group()
    if n > 1:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    try:
        yield
    finally:
        if dist.is_initialized():
            serve_mesh.forget_groups()
            dist.destroy_process_group()


def _rank_mesh(mesh):
    """This process's rank of ``mesh`` in its fake world: the data ranks
    are the mesh's pod x data."""
    d = math.prod(mesh.shape[a] for a in mesh_ctx.dp_axes(mesh))
    return serve_mesh.MeshPlan(d, mesh.shape.get("model", 1)).build()


def _shard(tree, placements, rm):
    return map_with_path(
        lambda path, leaf: sharding.shard_of(
            leaf, at(placements, path), rm, rm.coords), tree)


def _split(placements) -> list:
    """The leaves a placement tree splits: "path: placement"."""
    out = []
    map_with_path(lambda path, p: out.append(
        f"{'/'.join(path)}: {p}") if any(x is not None for x in p) else None,
        placements)
    return out


def build_lowerable(cfg, shape, mesh, *, device="cuda",
                    microbatches: int = 1):
    """One rank's step of the cell on fake tensors: (fn, args, layout),
    ``fn(*args)`` runs it; ``layout`` says which leaves are split and the
    rank's rows.  Call under the dry run's ``FakeTensorMode``, inside
    :func:`fake_world` of ``mesh``."""
    rm = _rank_mesh(mesh)
    plan = rm.plan
    model = encdec if cfg.family == "encdec" else lm
    p_specs = input_specs.params_specs(cfg, device)
    b = shape.global_batch

    if shape.kind == "train":
        ocfg = _opt_cfg(cfg)
        batch = input_specs.train_specs(cfg, shape, device)
        if plan.size == 1:
            step = ts_lib.make_train_step(cfg, ocfg,
                                          microbatches=microbatches)
            return step, (p_specs, opt_lib.init(ocfg, p_specs), batch), {
                "rows": b, "split": []}
        if microbatches > 1:
            raise ValueError("the port's mesh train step takes no "
                             "microbatches")
        if b % plan.data:
            raise ValueError(f"batch {b} does not split over {plan.data} "
                             f"data ranks")
        ep = moe_lib.ep_layout(cfg, rm, b // plan.data * shape.seq_len) \
            if cfg.moe else moe_lib.EPLayout(False)
        placements = moe_lib.expert_placements(p_specs, ep)
        params = _shard(p_specs, placements, rm)
        step = ts_lib.make_mesh_train_step(cfg, ocfg, rm, placements)
        return step, (params, opt_lib.init(ocfg, params), batch), {
            "rows": b // plan.data, "split": _split(placements)}

    rows = b // plan.data if b % plan.data == 0 and b >= plan.data else b
    local = dataclasses.replace(shape, global_batch=rows)
    if shape.kind == "prefill":
        batch = input_specs.prefill_specs(cfg, local, device)
        if cfg.family == "encdec":
            cache = input_specs.cache_specs(cfg, local, device)

            def fn(params, batch, cache):
                return encdec.prefill(params, cfg, batch["frames"], cache)

            return fn, (p_specs, batch, cache), {"rows": rows, "split": []}
        # frontend prefix tokens (vlm patches) extend the cached length
        max_len = shape.seq_len + (cfg.n_frontend_tokens
                                   if cfg.frontend == "patches" else 0)

        def fn(params, batch):
            return lm.prefill(params, cfg, batch["tokens"], max_len,
                              patch_embeds=batch.get("patch_embeds"))

        return fn, (p_specs, batch), {"rows": rows, "split": []}

    # decode: the serving engine's layout on this rank
    d_eff = plan.data if rows < b else 1
    tp = serve_mesh._tp_shards_hidden(cfg, plan)
    m_eff = plan.model if tp else 1
    serve = serve_mesh.RankMesh(
        serve_mesh.MeshPlan(d_eff, m_eff),
        (rm.data_index if d_eff > 1 else 0) * m_eff
        + (rm.model_index if tp else 0),
        model_group=rm.model_group if tp else None,
        data_group=rm.data_group if d_eff > 1 else None)
    cache = serve_mesh.cut_slot_state(
        cfg, {"cache": input_specs.cache_specs(cfg, shape, device)},
        serve)["cache"]
    params = serve_mesh.shard_params(p_specs, cfg, serve)
    token = torch.empty((rows,), dtype=torch.int32, device=device)
    group = serve.model_group

    def fn(params, token, cache):
        with mesh_ctx.serving_tp(group):
            return model.decode_step(params, cfg, token, cache)

    placements = serve_mesh.serve_params_pspecs(p_specs, cfg, serve)
    return fn, (params, token, cache), {"rows": rows,
                                        "split": _split(placements)}


def trace_cell(cfg, shape, mesh, *, device="cuda",
               microbatches: int = 1) -> dict:
    """Build and trace one cell's step on this rank under the recorders
    (``hlo_analysis.Recorder``, ``FlopCounterMode``, the kernels'
    ``Tally``): its costs and layout, before any derived metric."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with fake_world(mesh), FakeTensorMode():
        fn, args, layout = build_lowerable(cfg, shape, mesh, device=device,
                                           microbatches=microbatches)
        rec = hlo_analysis.Recorder()
        rec.track(args)
        arg_bytes = rec.live
        tally = kl.Tally()
        flop = FlopCounterMode(display=False)
        with kl.recording(tally), rec, flop:
            fn(*args)
        del fn, args
    k = tally.kernels.values()
    return {"peak_bytes": rec.peak, "argument_bytes": arg_bytes,
            "flops_ops": flop.get_total_flops(),
            "flops_kernels": sum(v["flops"] for v in k),
            "bytes_ops": rec.bytes,
            "bytes_kernels": sum(v["bytes"] for v in k),
            "collectives": hlo_analysis.collective_stats(rec.collectives),
            "kernels": tally.kernels, "layout": layout}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             microbatches: int = 1, verbose: bool = True,
             cfg_override=None, device="cuda", shape=None,
             mesh=None) -> dict:
    """One cell's record.  ``shape`` / ``mesh`` replace the named shape
    and the production mesh (the tests' small cells)."""
    cfg = cfg_override or archs.get(arch)
    shape = shape or SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "microbatches": microbatches, "device": str(device)}

    if shape_name == "long_500k" and not long_context_ok(cfg):
        rec.update(ok=True, skipped=True,
                   reason="pure full-attention arch at 524k ctx "
                          "(DESIGN.md §5)")
        return rec

    mesh = mesh or make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.time()
    costs = trace_cell(cfg, shape, mesh, device=device,
                       microbatches=microbatches)
    trace_s = time.time() - t0

    flops_dev = float(costs["flops_ops"] + costs["flops_kernels"])
    bytes_dev = float(costs["bytes_ops"] + costs["bytes_kernels"])
    coll = costs["collectives"]
    coll_bytes = float(sum(v["bytes"] for v in coll.values()))
    terms = hlo_analysis.roofline_terms(flops_dev, bytes_dev, coll_bytes)

    n_total, n_active = input_specs.n_params(cfg)
    tokens = (shape.global_batch * shape.seq_len if shape.kind != "decode"
              else shape.global_batch)
    mf = hlo_analysis.model_flops(
        n_active, tokens, "train" if shape.kind == "train" else "infer")
    n_dev = math.prod(mesh.sizes)
    useful_ratio = mf / (flops_dev * n_dev) if flops_dev else 0.0
    hbm = costs["peak_bytes"]

    rec.update(
        ok=True, skipped=False, trace_s=round(trace_s, 2),
        n_devices=n_dev, rank=0, rows_per_rank=costs["layout"]["rows"],
        split=costs["layout"]["split"],
        mem=dict(argument_bytes=costs["argument_bytes"],
                 temp_bytes=hbm - costs["argument_bytes"]),
        hbm_per_device=hbm, fits=hbm <= hlo_analysis.HBM_BYTES,
        flops_per_dev=flops_dev, flops_ops=float(costs["flops_ops"]),
        bytes_per_dev=bytes_dev,
        collectives={k: v for k, v in coll.items() if v["count"]},
        collective_bytes_per_dev=coll_bytes,
        roofline=terms, roofline_of=hlo_analysis.CARD,
        n_params=n_total, n_params_active=n_active,
        model_flops=mf, useful_flops_ratio=round(useful_ratio, 4),
        kernels=costs["kernels"],
    )
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_kind}] traced "
              f"{trace_s:.1f}s on fake {device}")
        print(f"  hbm/dev={hbm / 1e9:.2f} GB fits={rec['fits']} "
              f"(args {costs['argument_bytes'] / 1e9:.2f} GB)")
        print("  flops/dev=%.3e bytes/dev=%.3e" % (flops_dev, bytes_dev))
        print("  collectives:", rec["collectives"])
        print("  kernels:", rec["kernels"])
        print("  roofline:", {k: (f"{v:.2e}" if isinstance(v, float) else v)
                              for k, v in terms.items()})
    return rec


def all_cells(include_extras: bool = True):
    names = list(archs.ASSIGNED)
    if include_extras:
        names += archs.PAPER_OWN + archs.EXTRAS
    for arch in names:
        for shape in SHAPES:
            for mesh in ("single", "multi"):
                yield arch, shape, mesh


def _append(path: str, rec: dict):
    # one write() of the whole line: cells of --jobs append side by side
    with open(path, "a", buffering=1 << 20) as f:
        f.write(json.dumps(rec) + "\n")


def orchestrate(out_path: str, include_extras: bool, timeout: int,
                only_missing: bool = True, jobs: int = 1,
                device: str = "cuda"):
    done = set()
    if only_missing and os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("ok"):
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass
    # the longest traces first (prefill_32k: the blocked attention's
    # tiles, op by op), so the --jobs workers end together
    cells = sorted((c for c in all_cells(include_extras) if c not in done),
                   key=lambda c: c[1] != "prefill_32k")
    print(f"{len(cells)} cells to run ({len(done)} already done)",
          flush=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)

    def one(cell):
        arch, shape, mesh = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--device", device,
               "--json-out", out_path]
        try:
            proc = subprocess.run(cmd, timeout=timeout, capture_output=True,
                                  text=True)
        except subprocess.TimeoutExpired:
            _append(out_path, {"arch": arch, "shape": shape, "mesh": mesh,
                               "ok": False,
                               "error": f"trace timeout > {timeout}s"})
            return f"{arch} x {shape} x {mesh}: TIMEOUT"
        if proc.returncode != 0:
            # the cell's own process appended its record when it could
            last = proc.stderr.splitlines()[-1] if proc.stderr else "?"
            return f"{arch} x {shape} x {mesh}: FAILED: {last}"
        return f"{arch} x {shape} x {mesh}: ok"

    with ThreadPoolExecutor(max_workers=jobs) as pool:
        for i, msg in enumerate(pool.map(one, cells)):
            print(f"=== [{i + 1}/{len(cells)}] {msg}", flush=True)


def table(path: str) -> str:
    """The sweep's records (the last of each cell) as a markdown table, a
    row per (arch, shape) holding both meshes as "single / multi":
    per-rank GB, whether it fits, FLOPs and collective GB per rank, the
    dominant roofline term."""
    last = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            last[(r["arch"], r["shape"], r["mesh"])] = r

    def cols(r):
        if r is None:
            return ("not run",) + ("",) * 4
        if r.get("skipped"):
            return ("skipped",) + ("",) * 4
        if not r.get("ok"):
            err = r.get("error", "").strip().splitlines()
            return (f"failed: {err[-1][:100] if err else '?'}",) + ("",) * 4
        return (f"{r['hbm_per_device'] / 1e9:.2f}",
                "yes" if r["fits"] else "no",
                f"{r['flops_per_dev']:.3e}",
                f"{r['collective_bytes_per_dev'] / 1e9:.3f}",
                r["roofline"]["dominant"])

    rows = ["| arch | shape | GB / rank | fits | FLOPs / rank | "
            "collective GB / rank | dominant |",
            "|---|---|---|---|---|---|---|"]
    skipped = []
    for cell in all_cells():
        arch, shape, mesh = cell
        if mesh != "single":
            continue
        one = cols(last.get((arch, shape, "single")))
        two = cols(last.get((arch, shape, "multi")))
        if one[0] == two[0] == "skipped":
            skipped.append(f"{arch} {shape}")
            continue
        rows.append(f"| {arch} | {shape} | " + " | ".join(
            a if a == b else f"{a} / {b}" for a, b in zip(one, two)) + " |")
    if skipped:
        rows.append(f"\nSkipped on both meshes (pure attention at 524k): "
                    f"{', '.join(skipped)}.")
    return "\n".join(rows)


def apply_overrides(cfg, spec: str):
    """--override "ssm.chunk=64,remat=dots,moe.capacity_factor=1.0" """
    if not spec:
        return cfg
    for kv in spec.split(","):
        key, _, val = kv.partition("=")
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                continue
        if "." in key:
            sub, field = key.split(".", 1)
            subcfg = getattr(cfg, sub)
            cfg = cfg.replace(**{sub: dataclasses.replace(
                subcfg, **{field: val})})
        else:
            cfg = cfg.replace(**{key: val})
    return cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--override", default="",
                    help="comma-separated cfg overrides, e.g. ssm.chunk=64")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (the kernels' "
                         "shape-only route) or cpu (their plain versions)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-extras", action="store_true")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells traced at a time")
    ap.add_argument("--out", default="build/dryrun/dryrun.jsonl")
    ap.add_argument("--json-out", default=None,
                    help="append the single-cell record to this JSONL")
    ap.add_argument("--table", default=None,
                    help="print a sweep's JSONL as a markdown table")
    args = ap.parse_args()

    if args.table:
        print(table(args.table))
        return

    if args.all:
        orchestrate(args.out, not args.no_extras, args.timeout,
                    jobs=args.jobs, device=args.device)
        return

    try:
        cfg_override = None
        if args.override:
            cfg_override = apply_overrides(archs.get(args.arch),
                                           args.override)
        rec = run_cell(args.arch, args.shape, args.mesh, args.microbatches,
                       cfg_override=cfg_override, device=args.device)
        if args.override:
            rec["override"] = args.override
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "ok": False, "error": traceback.format_exc()[-2000:]}
        print(rec["error"], file=sys.stderr)
        if args.json_out:
            _append(args.json_out, rec)
        sys.exit(1)
    if args.json_out:
        _append(args.json_out, rec)


if __name__ == "__main__":
    main()
