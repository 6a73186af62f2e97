"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their top-level name, whole (``gs2d_tpu_torch`` is not ``gs2d_tpu``)."""

import ast
import glob
import json
import os
import subprocess
import sys

from conftest import BENCH, ROOT

REHEARSAL = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import run
from lib import control, program
from reference import splats
from conftest import TINY, manifest
for w in sorted(TINY):
    run.run_cell(w, 99, 0.0, False, "cpu", overrides=TINY[w],
                 log=lambda m: None, man=manifest())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_levels(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.path.join(
                             BENCH, "tests")))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_rehearsal_loads_no_jax():
    tops = _top_levels(REHEARSAL.format(bench=BENCH, root=ROOT))
    assert "gs2d_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "gs2d_tpu"}


def test_reference_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path[:0] = [{BENCH!r}]; "
            "import reference.splats; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = _top_levels(code)
    assert not tops & {"gs2d_tpu_torch", "gs2d_tpu", "jax"}


def test_reference_sources_import_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "gs2d_tpu_torch", "gs2d_tpu", "jax", "lib"), (path, n)
