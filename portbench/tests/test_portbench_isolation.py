"""What the benchmark may import: the reference imports nothing of the
program, and nothing here imports JAX or the JAX package."""
import ast
import glob
import os
import subprocess
import sys

from conftest import CODE

FORBIDDEN = {"jax", "jaxlib", "flax", "mlmc_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(CODE, "**", "*.py"), recursive=True):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(CODE, "reference", "*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"numpy", "torch", "reference"}, (path, tops)
    script = ("import sys; sys.path.insert(0, %r)\n"
              "import reference.darcy, reference.maxent, reference.moments, reference.synth\n"
              "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
              % (CODE, FORBIDDEN | {"mlmc_tpu_torch"}))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
