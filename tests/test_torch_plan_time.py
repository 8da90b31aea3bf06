"""``benchmarks/plan_time.py``: the host time to plan every TPC-H and
TPC-DS DataFrame query, on the CPU at a tiny scale."""
import json

import torch

from spark_rapids_tpu_torch.benchmarks import plan_time


def test_plan_time_plans_every_query(tmp_path, capsys):
    torch.set_num_threads(1)
    out = tmp_path / "plan_time.json"
    assert plan_time.main(["--device", "cpu", "--sf", "0.002", "--reps", "1",
                           "--out", str(out)]) == 0
    result = json.loads(out.read_text())
    assert result["queries"] == 22 + 99
    per = result["per_query_median_ms"]
    assert sum(k.startswith("tpch ") for k in per) == 22
    assert all(v > 0 for v in per.values())
    assert result["collect_ms_sum"] is None
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["queries"] == 121
