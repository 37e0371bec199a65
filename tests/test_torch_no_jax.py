"""The port stands alone: ``indic_cl_asr_torch`` and ``chip_smoke.py``
import no ``jax``/``flax``/``orbax`` and nothing of ``indic_cl_asr_tpu``
(checked in a fresh interpreter and by scanning the sources), and the
entry points raise without a CUDA card unless the CPU is asked for."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "indic_cl_asr_tpu")


def _port_sources():
    files = sorted((ROOT / "indic_cl_asr_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import indic_cl_asr_torch.train.eval, indic_cl_asr_torch.models.convert\n"
        "import indic_cl_asr_torch.train.step, indic_cl_asr_torch.data.pipeline\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(','.join(bad))\n" % (FORBIDDEN,)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, check=True,
    )
    assert res.stdout.strip() == ""


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_entry_points_need_a_card_unless_cpu_is_asked():
    from indic_cl_asr_torch import resolve_device
    from indic_cl_asr_torch.models.hybrid import HybridRNNTCTC, tiny_config
    from indic_cl_asr_torch.ops import _build

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        HybridRNNTCTC(tiny_config())
    if shutil.which("nvcc") is None and not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError):
            _build.nvcc_path()
