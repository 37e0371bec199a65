"""The control on the card at the cells' own sizes: the plain reference
in float8 put in the program's place fails at least one of the cell's
limits, and the program on the same seed passes them all. Run on the
machine with the card:

    python3 -m pytest cl_bench/tests/test_clbench_control_gpu.py -q
"""

import pytest
import torch

from cl_bench import check, limits
from cl_bench.run import ROOT, load
from cl_bench.work import tf32_off

CELLS = ["indicconformer_large.cl_task", "conformer_xlarge.cl_task",
         "indicconformer_large.wer_eval"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_and_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    tf32_off()
    wl = next(w for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
              if w["name"] == workload)
    cfg, mix = load("configs", wl["config"]), load("traffic", wl["traffic"])
    one = limits.train_seed if mix["kind"] == "train" else limits.eval_seed
    res = one(workload, cfg, mix, 424242, torch.device("cuda:0"), True)
    # the limited numbers a limits reading has (answers are counted in runs)
    lim = {k: v for k, v in check.load_limits(workload).items() if k in res["program"]}
    assert lim
    assert all(res["program"][k] <= v for k, v in lim.items()), res
    assert any(res["control"][k] > v for k, v in lim.items()), res
