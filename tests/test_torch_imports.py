"""The port and chip_smoke.py import nothing of JAX and nothing of the JAX
package: the machine with the card has no JAX. Nor do they import orbax,
PIL, matplotlib or scikit-learn, which it may lack too: the port writes its
own images and carries its own digits. The port's offline tools
(``paig_reproduction_tpu_torch/tools/``) load none of it when run either."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "matplotlib",
             "sklearn", "paig_reproduction_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "paig_reproduction_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_scan_sees_the_port():
    names = [os.path.relpath(p, REPO) for p in _port_files()]
    assert "chip_smoke.py" in names
    for path in (("models", "physics_net.py"), ("data", "generators.py"),
                 ("data", "assets.py"), ("data", "generate.py"),
                 ("train", "watchdog.py"), ("ops", "stn.py"),
                 ("train", "graphs.py"), ("parallel", "distributed.py"),
                 ("parallel", "mesh.py"), ("data", "native.py"),
                 ("utils", "flops.py"), ("tools", "__init__.py"),
                 ("tools", "fit_physics.py"), ("tools", "slot_rescue.py"),
                 ("tools", "analyze_tail.py"), ("tools", "seed_sweep.py"),
                 ("tools", "reference_runs.py")):
        assert os.path.join("paig_reproduction_tpu_torch", *path) in names


@pytest.mark.parametrize("name", ["fit_physics", "slot_rescue",
                                  "analyze_tail", "seed_sweep",
                                  "reference_runs"])
def test_tools_import_no_jax_when_run(name):
    """Each tool, run with --help in a fresh interpreter, has loaded no
    module of JAX or of the JAX package by its parser (the imports inside
    its functions are test_no_jax_imports' scan)."""
    import subprocess
    import sys
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['{name}', '--help']\n"
        "try:\n"
        f"    runpy.run_module('paig_reproduction_tpu_torch.tools.{name}',"
        " run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
