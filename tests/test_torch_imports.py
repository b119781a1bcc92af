"""The port stands alone: no module of ``src/repro_torch`` nor
``chip_smoke.py``/``chip_ab.py``/``examples/quickstart_torch.py``/
``examples/quantize_every_family_torch.py`` imports
jax or anything of the JAX package ``repro``."""
import ast
import os

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "chip_ab.py"),
           os.path.join(ROOT, "examples", "quickstart_torch.py"),
           os.path.join(ROOT, "examples", "quantize_every_family_torch.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_port_files_exist():
    files = _port_files()
    for script in ("chip_smoke.py", "chip_ab.py",
                   os.path.join("examples", "quickstart_torch.py"),
                   os.path.join("examples",
                                "quantize_every_family_torch.py")):
        assert os.path.exists(os.path.join(ROOT, script)), \
            f"{script} is missing"
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = [(ln, name) for ln, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path} imports {bad}"


def test_registry_modules_are_the_ports_own():
    from repro_torch.configs import _MODULES
    assert all(m.startswith("repro_torch.") for m in _MODULES.values())
