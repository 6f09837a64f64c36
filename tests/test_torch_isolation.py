"""The port imports nothing of the JAX package, and not jax.

Every module of yaha_tpu_torch, chip_smoke.py and the case file it
imports (tests/torch_dp_cases.py) is scanned with `ast`:
no `import yaha_tpu`, `import yaha_tpu.x`, `from yaha_tpu import ...` or
`from yaha_tpu.x import ...` (yaha_tpu_torch itself is allowed), and the
same for jax.  The
runtime side, a CLI run that loads no yaha_tpu module and no library of
yaha_tpu/native, is test_cli_imports_no_jax in tests/test_torch_staged.py.
"""
import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "yaha_tpu_torch", "**", "*.py"),
              recursive=True)) + [
                  "chip_smoke.py", "tests/torch_dp_cases.py"]


def _reference_imports(path, root=REPO, package="yaha_tpu"):
    """(line, module) of every import of `package` or `package`.* in a
    file (yaha_tpu, or jax); relative imports stay inside the file's own
    package."""
    with open(os.path.join(root, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n == package or n.startswith(package + ".")]
    return found


def test_scan_covers_the_port():
    assert "yaha_tpu_torch/models/staged.py" in PORT_FILES
    assert "yaha_tpu_torch/native/host.py" in PORT_FILES
    assert "yaha_tpu_torch/models/seeder.py" in PORT_FILES
    assert "yaha_tpu_torch/ops/seeds.py" in PORT_FILES
    assert "yaha_tpu_torch/parallel/mesh.py" in PORT_FILES
    assert "yaha_tpu_torch/parallel/distributed.py" in PORT_FILES
    assert "yaha_tpu_torch/entry.py" in PORT_FILES
    core = sorted(os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "yaha_tpu_torch", "core", "*.py")))
    assert len(core) == 10 and set(core) <= set(PORT_FILES)
    for path in ("index/build.py", "utils/rng.py", "io/fasta.py",
                 "io/index_io.py", "io/sam.py", "ops/dp_common.py"):
        assert "yaha_tpu_torch/" + path in PORT_FILES
    tools = sorted(os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "yaha_tpu_torch", "tools", "*.py")))
    assert len(tools) == 5 and set(tools) <= set(PORT_FILES)
    assert len(PORT_FILES) > 15


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_module_imports_nothing_of_yaha_tpu(path):
    assert _reference_imports(path) == []


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_module_imports_no_jax(path):
    assert _reference_imports(path, package="jax") == []


def test_scan_finds_reference_imports(tmp_path):
    """The scanner itself: each import form of the JAX package is found,
    the port's own package is not."""
    src = ("import yaha_tpu\n"
           "import yaha_tpu.cli as c\n"
           "from yaha_tpu.native import host\n"
           "from yaha_tpu import config\n"
           "import yaha_tpu_torch\n"
           "from yaha_tpu_torch.ops import sw_cuda\n"
           "from .ops import decode\n"
           "def f():\n"
           "    from yaha_tpu.utils import codec\n")
    (tmp_path / "m.py").write_text(src)
    assert [ln for ln, _ in _reference_imports("m.py", str(tmp_path))] == [
        1, 2, 3, 4, 9]
