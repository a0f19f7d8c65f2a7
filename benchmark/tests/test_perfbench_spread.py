"""benchmark/tools/spread.py on fixed inputs, worked by hand."""
import json
import statistics

import pytest

from benchmark.tools import spread


def test_iqr_is_statistics_quantiles():
    v = [9.5, 10.0, 10.0, 10.5, 11.0]
    # exclusive quartiles of 5 values: positions 1.5 and 4.5
    assert spread.iqr(v) == pytest.approx(10.75 - 9.75)


def test_farthest_run_left_out_where_it_narrows():
    v = [10.0, 10.5, 11.0, 9.5, 10.0, 30.0]
    assert spread.iqr(v) == pytest.approx(15.75 - 9.875)
    assert spread.less_farthest(v, spread.iqr) == pytest.approx(1.0)
    assert spread.less_farthest(v, lambda x: max(x) - min(x)) == \
        pytest.approx(1.5)
    # a set too small to drop a run keeps all of them
    assert spread.less_farthest([1.0, 2.0, 4.0], lambda x: max(x) - min(x)) \
        == 3.0


def test_two_sets(tmp_path):
    a = [10.0, 10.5, 11.0, 9.5, 10.0, 30.0]
    b = [10.0, 10.2, 10.4, 10.6, 10.8, 11.0]
    for name, vals in (("a", a), ("b", b)):
        (tmp_path / f"{name}.jsonl").write_text("\n".join(
            json.dumps({"result": {"metrics": {"frame_ms": {"value": x}}}})
            for x in vals))
    s = spread.spreads([spread.read_set(tmp_path / "a.jsonl"),
                        spread.read_set(tmp_path / "b.jsonl")])["frame_ms"]
    ta = 1.0 / statistics.median(a)
    tb = spread.less_farthest(b, spread.iqr) / statistics.median(b)
    assert s["tight_spreads"] == pytest.approx([ta, tb])
    assert s["tight_mean"] == pytest.approx((ta + tb) / 2)
    assert s["loose_spread"] == pytest.approx(5.875 / statistics.median(a))
    assert s["rule_of_five"] == pytest.approx(5 * s["loose_spread"])
    assert s["runs"] == [6, 6]
