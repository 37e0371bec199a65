"""The yardstick's copied arithmetic equals the port's today, and nothing
the benchmark runs imports JAX or the JAX package; the reference imports
nothing of the port."""

import ast
from pathlib import Path

import pytest

from cl_bench import work

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "indic_cl_asr_tpu"}


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_and_the_reference_none_of_the_port():
    files = sorted(ROOT.rglob("*.py"))
    assert files
    for f in files:
        tops = imported_tops(f)
        assert not tops & FORBIDDEN, f
        if "reference" in f.relative_to(ROOT).parts:
            assert "indic_cl_asr_torch" not in tops, f


SHAPES = [  # (B, T, E, H, lens): the cells' encoder shapes
    (16, 100, 512, 8, [75 + i for i in range(16)]),
    (16, 420, 512, 8, [300 + 7 * i for i in range(16)]),
    (16, 420, 1024, 8, [300 + 7 * i for i in range(16)]),
    (64, 200, 512, 8, [100 + i for i in range(64)]),
]


@pytest.mark.parametrize("B,T,E,H,lens", SHAPES)
def test_flash_formulas_equal_the_port_s(B, T, E, H, lens):
    from indic_cl_asr_torch.ops import flash_mhsa

    assert work.flash_forward(B, T, E, lens) == flash_mhsa.work(B, T, E, lens)
    assert work.flash_backward(B, T, E, lens, H) == flash_mhsa.work_backward(B, T, E, lens, H)


@pytest.mark.parametrize("B,T,U1", [(16, 100, 65), (16, 420, 257), (16, 200, 129)])
def test_lattice_formula_equals_the_port_s(B, T, U1):
    from indic_cl_asr_torch.ops import rnnt_loss

    for beta in (False, True):
        assert work.lattice(B, T, U1, beta) == rnnt_loss.work(B, T, U1, beta)


def test_decode_formula_and_peaks_equal_the_port_s():
    from indic_cl_asr_torch.ops import decode_fused
    from indic_cl_asr_torch.scripts import profile_step

    for args in [(64, 420, 640, 640, 257, 30000, 9000), (64, 100, 640, 640, 257, 7000, 2000)]:
        assert work.greedy_decode(*args) == decode_fused.work(*args)
    assert work.PEAK_FLOPS == profile_step.PEAK_FLOPS
    assert work.PEAK_BYTES_PER_S == profile_step.PEAK_BYTES_PER_S
