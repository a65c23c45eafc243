"""Every public top-level name of the reference has a counterpart in the
port: for each module under ``src/repro``, each name it defines at top
level (a function, a class, an assigned constant; not an import, not a
name with a leading underscore) is defined at top level in the module
of the same path under ``src/repro_torch``, or the allowlists below say
why not -- with the port's name of its counterpart where it has one.

Both packages are parsed with ``ast``; neither is imported.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

_XLA_ONLY = "XLA-only: the port has no jit, HLO or JAX device mesh"
_PALLAS = ("the Pallas kernel body: ported as CUDA C++ under the port's "
           "kernels/<name>/csrc/, launched from kernels/<name>/ops.py")

# reference modules the port has no counterpart of, and why
MODULES = {
    "distributed/act_sharding.py": _XLA_ONLY + " (sharding constraints "
    "on activations inside jit)",
    "distributed/devcount.py": _XLA_ONLY + " (forcing the host platform's "
    "device count in XLA_FLAGS before jax starts; the port spawns ranks, "
    "serve_mesh.run_world, and the dry run plays one rank of a fake world "
    "of any size, launch/dryrun.py:fake_world)",
    "kernels/block_step/kernel.py": _PALLAS,
    "kernels/decode_step/kernel.py": _PALLAS,
    "kernels/fused_mingru/kernel.py": _PALLAS,
    "kernels/fused_minlstm/kernel.py": _PALLAS,
    "kernels/scan/kernel.py": _PALLAS,
}

# names the port has no counterpart of under the same name: "port: X"
# names the counterpart (X a top-level name of the port's module, or
# "module.py:X" of another), anything else is the reason there is none
_PALLAS_OPS = ("Pallas interpret mode; a CUDA kernel has none: its "
               "wrapper runs the plain version on a CPU tensor")
NAMES = {
    ("*", "Array"): "the jax.Array type alias; the port annotates "
    "torch.Tensor",
    ("kernels/block_step/ops.py", "DEFAULT_INTERPRET"): _PALLAS_OPS,
    ("kernels/decode_step/ops.py", "DEFAULT_INTERPRET"): _PALLAS_OPS,
    ("kernels/fused_mingru/ops.py", "DEFAULT_INTERPRET"): _PALLAS_OPS,
    ("kernels/fused_minlstm/ops.py", "DEFAULT_INTERPRET"): _PALLAS_OPS,
    ("kernels/scan/ops.py", "DEFAULT_INTERPRET"): _PALLAS_OPS,
    ("kernels/scan/ops.py", "pad_to"): "pads T up to the Pallas tile "
    "grid; the CUDA scans take any T",
    ("kernels/scan/ops.py", "round_block_t"): "port: plan",
    ("distributed/context.py", "serving_tp_axis"): "port: serving_tp_group",
    ("distributed/context.py", "shard_map"): "jax's shard_map: a rank of "
    "the port runs its own code (serve_mesh.py:run_world)",
    ("distributed/serve_mesh.py", "ensure_host_devices"): "jax's host "
    "device count: the port spawns ranks (port: run_world)",
    ("distributed/serve_mesh.py", "serve_params_shardings"):
        "port: shard_params",
    ("distributed/serve_mesh.py", "slot_state_pspecs"):
        "port: cut_slot_state",
    ("distributed/serve_mesh.py", "slot_state_shardings"):
        "port: join_slot_state",
    ("launch/dryrun.py", "depth_variants"): "XLA's cost_analysis counts a "
    "scanned layer once, so the reference compiles small depths and fits "
    "the full one; the port's eager trace counts every layer: no fit",
    ("launch/dryrun.py", "extrapolate_costs"): "the fit over "
    "depth_variants; the port's eager trace counts every layer",
    ("launch/dryrun.py", "os"): "the reference's import-time "
    "os.environ['XLA_FLAGS'] for 512 host devices; the port opens a fake "
    "world a cell (port: fake_world)",
    ("launch/input_specs.py", "S"): "the jax.ShapeDtypeStruct alias; the "
    "port's specs are FakeTensors",
}


def _names(path: pathlib.Path) -> set:
    """The public names a module defines at top level."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                out.update(n.id for n in ast.walk(t)
                           if isinstance(n, ast.Name))
    return {n for n in out if not n.startswith("_")}


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _allowed(module: str, name: str):
    return NAMES.get((module, name), NAMES.get(("*", name)))


@pytest.mark.parametrize("module", REF_MODULES)
def test_every_public_name_has_a_counterpart(module):
    if module in MODULES:
        assert not (PORT / module).exists(), \
            f"{module} is ported now: drop it from MODULES"
        return
    assert (PORT / module).exists(), f"src/repro_torch/{module} is missing"
    missing = sorted(n for n in _names(REF / module) - _names(PORT / module)
                     if _allowed(module, n) is None)
    assert not missing, f"src/repro_torch/{module} lacks {missing}"


def test_the_allowlists_hold_no_stale_entry():
    """Each allowlisted module and name exists in the reference and is
    absent from the port; each named counterpart exists in the port."""
    for module in MODULES:
        assert (REF / module).exists(), module
    for (module, name), why in NAMES.items():
        mods = REF_MODULES if module == "*" else [module]
        assert any(name in _names(REF / m) for m in mods), (module, name)
        for m in mods:
            if name in _names(REF / m) and m not in MODULES:
                assert name not in _names(PORT / m), \
                    f"{m}:{name} is ported now: drop its entry"
        if why.startswith("port: ") or "(port: " in why:
            target = why.split("port: ", 1)[1].rstrip(")")
            other, _, target = target.rpartition(":")
            where = PORT / (str(pathlib.Path(module).parent / other)
                            if other else module)
            assert target in _names(where), (module, name, target)
