"""What a run and the reference load, compared by whole top-level module
names: jax, jaxlib, flax and tpu_ray never; tpu_ray_torch in the harness
only, never in the reference."""

import ast
import os
import subprocess
import sys

from benchmark.tests import tiny

REFUSED = {"jax", "jaxlib", "flax", "tpu_ray"}
PROBE = "import sys; {}; print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))"


def _loaded(code):
    p = subprocess.run([sys.executable, "-c", PROBE.format(code)], cwd=tiny.REPO,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr
    return set(p.stdout.strip().splitlines()[-1].split())


def test_the_reference_loads_neither_jax_nor_the_port():
    got = _loaded("import benchmark.reference.render, benchmark.reference.fit")
    assert not got & (REFUSED | {"tpu_ray_torch"})


def test_a_run_loads_the_port_and_no_jax(tmp_path):
    root = tiny.make_root(tmp_path)
    got = _loaded("from benchmark.tests import tiny; import pathlib; "
                  f"tiny.main(['--root', {str(root)!r}, '--workload', 'mixed.fit', "
                  "'--seed', '5', '--trace', '1'])")
    assert "tpu_ray_torch" in got and not got & REFUSED


def test_no_source_names_a_refused_module():
    """Every import statement under benchmark/, by whole top-level name; the
    reference's also without tpu_ray_torch."""
    for path in (tiny.REPO / "benchmark").rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names.add(node.module.split(".")[0])
        assert not names & REFUSED, path
        if "reference" in path.parts:
            assert "tpu_ray_torch" not in names, path
