"""lightfm_tpu_torch stands alone: no jax, no lightfm_tpu, no silent CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((ROOT / "lightfm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("torch_*.py")))  # the port's chip probes


def _run(code: str, cwd=ROOT, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_neither_jax_nor_lightfm_tpu(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "lightfm_tpu"), (path, name)


def test_import_without_jax_loads_no_lightfm_tpu_module():
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import lightfm_tpu_torch\n"
        "from lightfm_tpu_torch import evaluation, retrieval, interop, checkpoint\n"
        "from lightfm_tpu_torch.ops import ranking, rank_counts, adagrad_update, _build\n"
        "from lightfm_tpu_torch.ops import grad_sums, warp_fit\n"
        "from lightfm_tpu_torch import fast_warp, train, losses, observability\n"
        "from lightfm_tpu_torch import data, cross_validation, native, datasets\n"
        "from lightfm_tpu_torch.datasets import _common, movielens, stackexchange, synthetic\n"
        "from lightfm_tpu_torch.parallel import mesh, ingest\n"
        "print(json.dumps(sorted(m for m, mod in sys.modules.items() if mod is not None"
        " and m.split('.')[0] in ('jax', 'jaxlib', 'lightfm_tpu'))))\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_default_device_is_cuda_and_never_falls_back_to_cpu():
    from lightfm_tpu_torch import LightFM

    if torch.cuda.is_available():
        assert LightFM().device.startswith("cuda")
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LightFM()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LightFM(device="cuda")
    assert LightFM(device="cpu").device == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would really run")
    out = _run(f"import runpy; runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='__main__')")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # Alone in a directory, without the package, it fails too.
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = _run("import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')", cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
