"""bench.py orchestration harness.

The orchestrator never opens the card: every device phase runs, one at a time,
in a disposable subprocess with its own timeout, one fresh-process retry, a
global deadline, and marker-based result parsing, so one crashed or hung phase
cannot null the record. These tests pin that machinery with stub payloads (no
device access)."""

import importlib
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402


def _fresh():
    importlib.reload(bench)
    bench._DEADLINE = time.time() + 300
    return bench


def test_device_phase_success_and_partial_record():
    b = _fresh()
    r = b._device_phase("ok", "print(json.dumps({'x': 1}))\n")
    assert r == {"x": 1} and b.PARTIAL["ok"] == {"x": 1}


def test_device_phase_timeout_kills_and_retries():
    b = _fresh()
    t0 = time.time()
    r = b._device_phase("wedge", "import time\ntime.sleep(9999)\n", timeout=3)
    # two attempts, both killed; error recorded, orchestration continues
    assert r is None
    assert "TIMEOUT" in b.PARTIAL["wedge"]["ERROR"]
    assert time.time() - t0 < 30


def test_device_phase_crash_recorded():
    b = _fresh()
    r = b._device_phase("boom", "raise RuntimeError('kaput')\n", timeout=60)
    assert r is None and "rc=1" in b.PARTIAL["boom"]["ERROR"]


def test_device_phase_respects_global_deadline():
    b = _fresh()
    b._DEADLINE = time.time() + 10   # under the reserve margin
    r = b._device_phase("late", "print(json.dumps({}))\n")
    assert r is None
    assert "deadline" in b.PARTIAL["late"]["ERROR"]


def test_device_phase_parses_past_interleaved_noise():
    b = _fresh()
    r = b._device_phase(
        "noisy",
        "print('WARNING: junk')\nprint(json.dumps({'v': 7}))\n"
        "print('trailing')\n")
    assert r == {"v": 7}


def test_subprocess_json_marker_survives_noise():
    b = _fresh()
    r = b._subprocess_json(
        "print('unrelated line')\nprint(json.dumps({'a': [1, 2]}))\n"
        "print('more noise')\n", timeout=120)
    assert r == {"a": [1, 2]}


def test_wedged_phase_does_not_block_later_phases():
    """The exact round-2 failure shape: phase 1 wedges, later phases must still
    produce numbers and the headline JSON must carry the partials."""
    b = _fresh()
    b._device_phase("first", "import time\ntime.sleep(9999)\n", timeout=2,
                    retries=0)
    r = b._device_phase("second", "print(json.dumps({'fine': True}))\n")
    assert r == {"fine": True}
    assert "TIMEOUT" in b.PARTIAL["first"]["ERROR"]
    assert b.PARTIAL["second"] == {"fine": True}
