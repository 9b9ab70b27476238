"""Guard the official bench record format.

The driver captures bench.py's stdout tail and parses the LAST JSON line as
the official record. Rounds 2-3 both scored `parsed: null`
because the only output line was enormous (full extras inline) and the
headline fields sat in the truncated front. The contract now: a DETAIL line
with everything, then one compact final line with exactly the four headline
fields — small enough that no tail capture can truncate it."""

import io
import json
import sys

import pytest

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])
import bench  # noqa: E402


def _capture_emit(result):
    buf = io.StringIO()
    out, sys.stdout = sys.stdout, buf
    try:
        bench._emit_record(result)
    finally:
        sys.stdout = out
    return buf.getvalue().splitlines()


def test_final_line_is_compact_and_parses():
    result = {
        "metric": "walk_steps_per_s_per_chip",
        "value": 1.41e7,
        "unit": "steps/s",
        "vs_baseline": 1.23,
        "extras": {"huge": "x" * 100_000},  # the round-2/3 failure shape
    }
    lines = _capture_emit(result)
    assert len(lines) == 2
    final = json.loads(lines[-1])  # last line must parse standalone
    assert final == {"metric": "walk_steps_per_s_per_chip", "value": 1.41e7,
                     "unit": "steps/s", "vs_baseline": 1.23}
    assert len(lines[-1]) < 512  # immune to any plausible tail truncation
    detail = json.loads(lines[0].removeprefix("DETAIL "))
    assert detail["extras"]["huge"]  # nothing lost from the detail record


def test_final_line_with_null_fields_parses():
    lines = _capture_emit({"metric": "m", "value": None, "unit": "u",
                           "vs_baseline": None, "extras": {}})
    final = json.loads(lines[-1])
    assert final["value"] is None and "extras" not in final


def test_device_peaks_known_kind_and_unknown_raises():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["l2_bytes"] == 50 * 2**20
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("Unlisted Accelerator 1")
