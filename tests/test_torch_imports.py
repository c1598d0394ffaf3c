"""The port and chip_smoke.py import nothing of JAX and nothing of the JAX
package: the machine with the card has no JAX. Nor do they import orbax,
PIL, matplotlib or scikit-learn, which it may lack too: the port writes its
own images and carries its own digits."""
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
                 ("utils", "flops.py")):
        assert os.path.join("paig_reproduction_tpu_torch", *path) in names
