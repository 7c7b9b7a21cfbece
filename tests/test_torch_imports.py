"""lfr_tpu_torch, chip_smoke.py and the port's scripts import torch, numpy,
scipy (the solver's partition) and the standard library only: none of the
JAX stack (jax, flax, optax, msgpack), nothing of lfr_tpu, no image library
(the card's machine has no cv2, PIL or torchvision) and not sklearn (the
training corpus finds its photos through ``sysconfig``)."""

import ast
import pathlib
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parents[1] / "lfr_tpu_torch"
ROOT = PKG.parent
FORBIDDEN = ("jax", "flax", "optax", "msgpack", "lfr_tpu", "cv2", "PIL", "torchvision",
             "sklearn")
#: Scripts of the port outside the package, by module name and path.
SCRIPTS = {
    "chip_smoke": ROOT / "chip_smoke.py",
    "bench_corr_variants_torch": ROOT / "scripts" / "bench_corr_variants_torch.py",
    "ablate_torch_corr": ROOT / "scripts" / "ablate_torch_corr.py",
    "profile_torch_solve": ROOT / "scripts" / "profile_torch_solve.py",
    "profile_torch_triangulation": ROOT / "scripts" / "profile_torch_triangulation.py",
    "train_torch_loss_drop": ROOT / "scripts" / "train_torch_loss_drop.py",
}


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path
    yield from SCRIPTS.items()


def test_importing_every_module_loads_no_jax():
    names = [name for name, _ in _modules()]
    assert "lfr_tpu_torch.pipelines.refinement" in names
    assert "lfr_tpu_torch.pipelines.match_graph" in names
    for module in ("graph", "tracks", "partition", "lm", "buckets", "solve"):
        assert f"lfr_tpu_torch.solver.{module}" in names
    assert "lfr_tpu_torch.ops.interpolate" in names
    for module in ("io.colmap_db", "io.colmap_model", "sfm.cameras", "sfm.geometry",
                   "sfm.verify", "sfm.triangulate", "pipelines.import_features",
                   "pipelines.triangulation", "io.jpeg", "ops.nn_dist", "eval.eth3d",
                   "eval.compare", "pipelines.dataset_tools", "pipelines.benchmark",
                   "__main__", "ops.sift", "ops.doh", "ops.surf",
                   "pipelines.extract_features", "sfm.ba", "sfm.pnp", "sfm.mapper",
                   "pipelines.reconstruction", "ops.host_build", "solver.native",
                   "models.train", "models.torch_import", "utils.corpus"):
        assert f"lfr_tpu_torch.{module}" in names
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'scripts')!r})\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_import_statement_names_jax():
    for name, path in _modules():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in FORBIDDEN, f"{name} imports {mod}"
