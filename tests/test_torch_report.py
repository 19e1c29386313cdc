"""``pygim_tpu_torch/bench/report.py`` on the CPU at a small size: the
full-size report of config 4 (square int4 core, int8 aggregate) runs end
to end, validates, and describes its operand."""

import json

import pytest

from pygim_tpu_torch.bench import report


@pytest.mark.parametrize("dataset", ["rmat-2000-40000", "rmat-3000-24000"])
def test_report_runs_on_cpu(dataset, capsys):
    res = report.main(dataset, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["prepare_s"] == res["prepare_s"]
    assert res["inference"]["validate"] == "OK"
    assert res["spmm"]["verify"] == "OK"
    op = res["operand"]
    assert op["core_dtype"] == "int4"
    assert 0 < op["core_coverage"] <= 1
    assert "core_fill" in res["prepare_phases_ms"]
    (lo, k, w), = op["bands"]
    assert lo == 0 and w >= k and w % 32 == 0


def test_report_args_default_to_config_4():
    c = report.config()
    assert (c.backend, c.hybrid_shape, c.hybrid_dtype, c.hybrid_core_bytes,
            report.AGG_DTYPE, report.HIDDEN) == \
        ("hybrid", "square", "int4", 6 << 30, "int8", 256)
    assert report.main.__defaults__[0] == "ogbn-products"
