"""The port stands alone: ``indic_cl_asr_torch`` and ``chip_smoke.py``
import no ``jax``/``flax``/``orbax`` and nothing of ``indic_cl_asr_tpu``
(checked in a fresh interpreter and by scanning the sources), name none
of the JAX package's native sources or its built library (the port builds
its own copy, ``csrc/host/``), and the entry points raise without a CUDA
card unless the CPU is asked for."""

import ast
import importlib
import os
import re
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
        "import indic_cl_asr_torch.train.driver, indic_cl_asr_torch.train.logger\n"
        "import indic_cl_asr_torch.cl.methods, indic_cl_asr_torch.cl.ewc\n"
        "import indic_cl_asr_torch.cl.mas, indic_cl_asr_torch.cl.lwf\n"
        "import indic_cl_asr_torch.utils.checkpoint, indic_cl_asr_torch.ops.joint_fused\n"
        "import indic_cl_asr_torch.scripts._common, indic_cl_asr_torch.scripts.transcribe\n"
        "import indic_cl_asr_torch.analysis.results, indic_cl_asr_torch.utils.config\n"
        "import indic_cl_asr_torch.scripts.eval_pretrained\n"
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


def _port_files():
    files = sorted(p for p in (ROOT / "indic_cl_asr_torch").rglob("*")
                   if p.is_file() and p.suffix in (".py", ".cu", ".cuh", ".cpp", ".yaml"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_none_of_the_jax_packages_native_runtime(path):
    """``native/libindic_native.so`` and ``native/*.cpp`` belong to the JAX
    package; the port loads and builds only ``csrc/host/``."""
    found = re.findall(r"native/(?:libindic_native|[\w*]+\.(?:cpp|so))|libindic_native",
                       path.read_text())
    assert not found, f"{path}: {found}"


@pytest.mark.parametrize("script,argv", [
    ("profile_step", ["--steps", "1"]),
    ("flops_audit", []),
    ("bench_eval", ["--tiny"]),
])
def test_host_side_scripts_need_a_card_unless_cpu_is_asked(script, argv, monkeypatch):
    mod = importlib.import_module(f"indic_cl_asr_torch.scripts.{script}")
    if torch.cuda.is_available():
        pytest.skip("a card is present: these run on it")
    # nothing may run before the device is resolved
    monkeypatch.setattr(mod, "flagship_step" if script != "bench_eval" else "HybridRNNTCTC",
                        None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv + ["--device", "cuda"])


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
