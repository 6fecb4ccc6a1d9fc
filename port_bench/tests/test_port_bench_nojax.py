"""No JAX: the module check compares whole top-level names, nothing under
port_bench imports JAX, flax or the JAX package, and a run without a card
exits non-zero and prints no result."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import spec
from port_bench.tests import tiny

RUN = tiny.run_module()


@pytest.mark.parametrize("modules, found", [
    ({"rank_tpu_torch": 1, "rank_tpu_torch.models": 1, "torch": 1}, []),
    ({"jaxtyping": 1, "flaxen": 1, "rank_tpu_extra": 1}, []),
    ({"rank_tpu": 1}, ["rank_tpu"]),
    ({"rank_tpu.models.registry": 1}, ["rank_tpu"]),
    ({"jax._src.core": 1, "jaxlib.xla_client": 1, "flax.linen": 1},
     ["flax", "jax", "jaxlib"]),
])
def test_forbidden_modules_by_whole_top_level_name(modules, found):
    assert RUN.forbidden_modules(modules) == found


def test_no_file_of_the_benchmark_imports_jax():
    for path in Path(spec.HERE).rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in RUN.FORBIDDEN, (path, name)


def test_a_run_without_a_card_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(Path(spec.HERE) / "run.py"), "--workload", "din.serve.poisson",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_the_harness_loads_no_jax_in_a_run(tmp_path):
    """What a tiny run loads, in a fresh process: no forbidden module."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from port_bench.tests import tiny\n"
        "tiny.run('xdeepfm.train.b1024', seconds=0.3)\n"
        "tiny.run('din.serve.poisson', seconds=0.3)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax','jaxlib','flax','rank_tpu'}))\n"
    ) % str(spec.CHECKOUT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
