"""What the benchmark loads: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or the JAX package's, compared whole (the port's
``psfmc_tpu_torch`` begins with ``psfmc_tpu``); the reference nothing of
the port either."""
import subprocess
import sys

from portbench.harness import common

from portbench_support import ROOT

_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""


def _tops(body):
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT, body=body)],
                         capture_output=True, text=True, timeout=300, check=True)
    import json

    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_check_compares_whole_top_level_names():
    assert common.forbidden_modules({"psfmc_tpu_torch.ops": 1, "jaxtyping": 1}) == []
    assert common.forbidden_modules({"psfmc_tpu.ops": 1, "jax.numpy": 1}) == ["jax", "psfmc_tpu"]


def test_a_run_loads_no_jax_and_not_the_jax_package(tmp_path):
    body = f"""
import json
sys.argv = ['x']
from portbench.harness import common
from portbench import run
cell = common.cell_for('j0005.single')
cell.config = json.load(open({ROOT + '/portbench/tests/tiny.json'!r}))
res = run.run_cell(cell, 3, 0.1, False, 'cpu', sizes={{'chains': 38, 'burn': 2, 'iterations': 2}},
                   limits={{}})
"""
    tops = _tops(body)
    assert "psfmc_tpu_torch" in tops
    assert not tops & set(common.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    tops = _tops("import portbench.reference.posterior, portbench.bounds")
    assert not tops & (set(common.FORBIDDEN) | {"psfmc_tpu_torch"})
