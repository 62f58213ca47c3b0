"""What a run loads: never jax, jaxlib, flax or the JAX package (the port
kornia_tpu_torch begins with its name, so top-level names are compared
whole), and the reference loads nothing of the port."""

import ast
import os
import subprocess
import sys
import types

from benchmark import harness

REF = os.path.join(harness.BENCH, "reference")


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kornia_tpu_torch_probe",
                        types.ModuleType("kornia_tpu_torch_probe"))
    assert "kornia_tpu" not in harness.loaded_forbidden() or \
        "kornia_tpu" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jaxlib.fake",
                        types.ModuleType("jaxlib.fake"))
    assert "jaxlib" in harness.loaded_forbidden()


def test_reference_sources_import_nothing_of_the_port():
    for name in os.listdir(REF):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                assert m.split(".")[0] in ("__future__", "numpy", "torch",
                                           "functools", "json", "math", "os",
                                           "typing"), (name, m)


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_reference_loads_nothing_of_the_port_in_a_fresh_process():
    out = _fresh("import sys; sys.path.insert(0, '.');"
                 "import benchmark.reference.orb, benchmark.reference.solve;"
                 "print(sorted({m.split('.')[0] for m in sys.modules}))")
    tops = set(eval(out))
    assert not tops & {"kornia_tpu_torch", "kornia_tpu", "jax", "jaxlib",
                       "flax"}


def test_a_dry_run_loads_no_jax_module():
    out = _fresh(
        "import sys; sys.path.insert(0, '.'); sys.path.insert(0,"
        " 'benchmark/tests'); from conftest import dry_run;"
        "dry_run('orb_kitti.stream', 1.0); from benchmark import harness;"
        "print(harness.loaded_forbidden());"
        "print('kornia_tpu_torch' in sys.modules)")
    forbidden, port = out.strip().splitlines()[-2:]
    assert forbidden == "[]" and port == "True"
