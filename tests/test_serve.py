"""Job-server entry point (serve.py) — the reference's Spark-JobServer surface
(Main.scala:99-143): validate parses the single rw.input config string, run_job
returns the output path, and the REST server runs jobs asynchronously."""

import json
import time
import urllib.request

import pytest

from stellar_rw_tpu import serve
from stellar_rw_tpu.utils.config import TaskName


def test_validate_parses_rw_input(karate_path, tmp_path):
    cfg = {"rw.input": f"--cmd randomwalk --input {karate_path} "
                       f"--output {tmp_path} --walkLength 3 --numWalks 1"}
    params = serve.validate(cfg)
    assert params.cmd == TaskName.randomwalk
    assert params.walk_length == 3 and params.num_walks == 1
    assert params.input == str(karate_path)


def test_validate_rejects_bad_config(tmp_path):
    with pytest.raises(ValueError):
        serve.validate({})  # missing rw.input (reference reads it at Main.scala:139)
    with pytest.raises(ValueError):
        # unparsable argv -> the reference's MatchError analog
        serve.validate({"rw.input": "--cmd nosuch --input x --output y"})


def test_run_job_returns_output_path(karate_path, tmp_path):
    out = tmp_path / "job_out"
    params = serve.validate(
        {"rw.input": f"--cmd randomwalk --input {karate_path} --output {out} "
                     f"--walkLength 2 --numWalks 1 --weighted false"})
    result = serve.run_job(params)
    assert result == str(out)  # JobOutput = params.output (Main.scala:126)
    assert (out / "path" / "part-00000").exists()


def _http(method, url, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_rest_job_lifecycle(karate_path, tmp_path):
    srv = serve.JobServer()
    srv.start()
    host, port = srv.address
    base = f"http://{host}:{port}"
    try:
        out = tmp_path / "rest_out"
        code, job = _http("POST", f"{base}/jobs", {
            "rw.input": f"--cmd randomwalk --input {karate_path} --output {out} "
                        f"--walkLength 2 --numWalks 1 --weighted false"})
        assert code == 202 and job["status"] in ("RUNNING", "FINISHED")
        jid = job["jobId"]
        srv.wait(jid, timeout=120)
        code, done = _http("GET", f"{base}/jobs/{jid}")
        assert code == 200 and done["status"] == "FINISHED", done
        assert done["result"] == str(out)
        assert (out / "path" / "part-00000").exists()
        # listing + bad config + unknown id
        code, lst = _http("GET", f"{base}/jobs")
        assert code == 200 and any(j["jobId"] == jid for j in lst["jobs"])
        code, err = _http("POST", f"{base}/jobs", {"wrong": "key"})
        assert code == 400
        code, _ = _http("GET", f"{base}/jobs/doesnotexist")
        assert code == 404
    finally:
        srv.stop()


def test_failed_job_reports_error(tmp_path):
    srv = serve.JobServer()
    try:
        job = srv.submit(["--cmd", "randomwalk", "--input", "/nonexistent/file",
                          "--output", f"{tmp_path}/x"])
        srv.wait(job.id, timeout=60)
        assert job.status == "ERROR" and job.error
    finally:
        srv.stop()


def test_rest_jobs_run_in_subprocess_and_worker_death_is_isolated(
        karate_path, tmp_path):
    """REST jobs run in disposable worker subprocesses, so a job whose worker
    DIES reports ERROR and leaves the server fully able to run the next
    job."""
    srv = serve.JobServer()
    srv.start()
    host, port = srv.address
    base = f"http://{host}:{port}"
    try:
        # worker dies: unreadable input makes the CHILD PROCESS exit nonzero
        # (server-side validate cannot catch it — it fails inside the worker)
        code, bad = _http("POST", f"{base}/jobs", {
            "rw.input": f"--cmd randomwalk --input /nonexistent/graph.txt "
                        f"--output {tmp_path}/bad --walkLength 2 --numWalks 1"})
        assert code == 202
        srv.wait(bad["jobId"], timeout=120)
        code, done = _http("GET", f"{base}/jobs/{bad['jobId']}")
        assert done["status"] == "ERROR" and "rc=" in done["error"]

        # the server survives and the next job completes normally
        out = tmp_path / "good"
        code, good = _http("POST", f"{base}/jobs", {
            "rw.input": f"--cmd randomwalk --input {karate_path} "
                        f"--output {out} --walkLength 2 --numWalks 1 "
                        f"--weighted false"})
        assert code == 202
        srv.wait(good["jobId"], timeout=180)
        code, done = _http("GET", f"{base}/jobs/{good['jobId']}")
        assert done["status"] == "FINISHED", done
        assert (out / "path" / "part-00000").exists()
    finally:
        srv.stop()


def test_job_timeout_kills_wedged_worker(karate_path, tmp_path):
    """A worker exceeding job_timeout is killed (whole process group) and the
    job reports a TIMEOUT error — the hung-job containment."""
    srv = serve.JobServer(job_timeout=1.0)
    try:
        # hang simulation: a sleep wrapper via argv is not expressible, so
        # rely on a real (short) timeout against the genuine worker startup
        # cost (jax import + compile >> 1 s)
        job = srv.submit([
            "--cmd", "randomwalk", "--input", karate_path,
            "--output", f"{tmp_path}/t", "--walkLength", "50",
            "--numWalks", "10", "--weighted", "false"])
        srv.wait(job.id, timeout=60)
        assert job.status == "ERROR" and "TIMEOUT" in job.error
    finally:
        srv.stop()


def test_concurrent_workers_need_one_card_each():
    """One JAX process per card: one worker without cards, one worker per
    listed card, and a card listed twice is refused."""
    with pytest.raises(ValueError, match="lists a card twice"):
        serve.JobServer(cards=["0", "0"])
    for cards, slots in ((None, [None]), (["0", "1"], ["0", "1"])):
        srv = serve.JobServer(cards=cards)
        try:
            assert list(srv._free_cards.queue) == slots
        finally:
            srv.stop()
