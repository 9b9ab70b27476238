"""Service entry point — the counterpart of the reference's Spark-JobServer
integration (reference Main.scala:99-143; usage README.md:35-78).

The reference implements the job-server `SparkJob` API: `JobData = Params`,
`JobOutput = String` (the output path); `validate` re-parses a single `rw.input`
config string as argv (Main.scala:137-143, key read at :139) and `runJob` executes
the same pipeline as the CLI (Main.scala:109-127). Here the same two functions are
plain Python (`validate(config) -> Params`, `run_job(params) -> str`, both sharing
the CLI's parse/dispatch path), plus a thin stdlib HTTP server exposing them as the
job-server REST surface:

  POST /jobs   body {"rw.input": "--cmd ... --input ... --output ..."}
               -> 202 {"jobId": ..., "status": "RUNNING"}   (job runs async)
  GET  /jobs/<id>  -> {"jobId", "status": RUNNING|FINISHED|ERROR, "result"|"error"}
  GET  /jobs       -> list of the above

No external dependencies. Every job runs in a DISPOSABLE
`python -m stellar_rw_tpu <argv>` subprocess. The server process never imports
JAX, so it never opens a card; a job that crashes or hangs is killed with its
process group, and the server and every later job keep working. This matches
the reference's deployment shape too (the job-server JVM supervises separate
Spark driver contexts).

One JAX process per card: a worker reserves most of a card's memory when it
starts, so a second worker on the same card would fail. Without `cards`, jobs
therefore run one at a time (like one SparkContext per job-server context;
queued jobs report RUNNING). With `cards`, one worker runs per listed card,
each seeing only its own card through CUDA_VISIBLE_DEVICES.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .utils.config import Params, parse

CONFIG_KEY = "rw.input"  # reference Main.scala:139


def validate(config: dict) -> Params:
    """Parse a job-server config into Params (reference Main.validate:137-143).

    The reference reads the single `rw.input` string and whitespace-splits it into
    argv; a missing key or unparsable argv fails the job (the reference's match is
    non-exhaustive and throws MatchError on parse failure — here a ValueError).
    """
    if CONFIG_KEY not in config:
        raise ValueError(f"config key {CONFIG_KEY!r} is required")
    argv = str(config[CONFIG_KEY]).split()
    params = parse(argv)
    if params is None:
        raise ValueError(f"could not parse {CONFIG_KEY}: {config[CONFIG_KEY]!r}")
    return params


def run_job(params: Params) -> str:
    """Execute the pipeline; JobOutput = the output path (reference Main.scala:126)."""
    from . import cli

    return cli.run_job(params)


@dataclass
class _Job:
    id: str
    status: str = "RUNNING"            # RUNNING | FINISHED | ERROR
    result: str | None = None
    error: str | None = None
    thread: threading.Thread | None = field(default=None, repr=False)

    def as_dict(self) -> dict:
        d = {"jobId": self.id, "status": self.status}
        if self.result is not None:
            d["result"] = self.result
        if self.error is not None:
            d["error"] = self.error
        return d


class JobServer:
    """Minimal REST job server over the validate/run_job pair."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 job_timeout: float | None = None,
                 cards: list[str] | None = None):
        if cards is not None and len(set(cards)) != len(cards):
            raise ValueError(
                f"cards={cards} lists a card twice: a second JAX process on a "
                "card fails for want of memory")
        self._jobs: dict[str, _Job] = {}
        self._lock = threading.Lock()
        # free cards; a worker holds one for its whole run (None = the
        # default device set, for the single-worker server)
        self._free_cards: queue.Queue = queue.Queue()
        for card in cards or [None]:
            self._free_cards.put(card)
        self.job_timeout = job_timeout
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path.rstrip("/") != "/jobs":
                    return self._reply(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    config = json.loads(self.rfile.read(n) or b"{}")
                    validate(config)
                except (ValueError, json.JSONDecodeError) as e:
                    return self._reply(400, {"error": str(e)})
                job = server.submit(str(config[CONFIG_KEY]).split())
                self._reply(202, job.as_dict())

            def do_GET(self):
                parts = [p for p in self.path.split("/") if p]
                if parts == ["jobs"]:
                    with server._lock:
                        return self._reply(
                            200, {"jobs": [j.as_dict() for j in server._jobs.values()]})
                if len(parts) == 2 and parts[0] == "jobs":
                    with server._lock:
                        job = server._jobs.get(parts[1])
                    if job is None:
                        return self._reply(404, {"error": "no such job"})
                    return self._reply(200, job.as_dict())
                self._reply(404, {"error": "not found"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._serve_thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    def submit(self, argv: list[str]) -> _Job:
        """Run a job asynchronously; returns its tracking record.

        The job runs as a disposable `python -m stellar_rw_tpu <argv>`
        subprocess in its own process group, holding one free card slot: a
        crashed or hung worker is killed/reaped without touching the server
        process. Raises ValueError if argv does not parse."""
        params = parse(list(argv))
        if params is None:
            raise ValueError(f"could not parse job argv: {argv!r}")
        job = _Job(id=uuid.uuid4().hex[:12])

        def work():
            card = self._free_cards.get()
            try:
                env = dict(os.environ)
                if card is not None:
                    env["CUDA_VISIBLE_DEVICES"] = str(card)
                proc = subprocess.Popen(
                    [sys.executable, "-m", "stellar_rw_tpu"] + list(argv),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, start_new_session=True, env=env)
                try:
                    _, err = proc.communicate(timeout=self.job_timeout)
                except subprocess.TimeoutExpired:
                    try:  # kill the whole process group, children included
                        os.killpg(proc.pid, signal.SIGKILL)
                    except Exception:
                        proc.kill()
                    proc.communicate()
                    job.error = (f"TIMEOUT: worker killed after "
                                 f"{self.job_timeout:.0f}s")
                    job.status = "ERROR"
                    return
                if proc.returncode == 0:
                    job.result = params.output
                    job.status = "FINISHED"
                else:
                    job.error = (f"worker exited rc={proc.returncode}: "
                                 f"{err[-1000:]}")
                    job.status = "ERROR"
            except Exception as e:  # Popen/communicate failure must not
                job.error = f"{type(e).__name__}: {e}"   # strand the job
                job.status = "ERROR"
            finally:
                self._free_cards.put(card)

        job.thread = threading.Thread(target=work, daemon=True)
        with self._lock:
            self._jobs[job.id] = job
        job.thread.start()
        return job

    def start(self) -> None:
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._serve_thread.start()

    def stop(self) -> None:
        # shutdown() blocks forever if serve_forever() was never entered — only
        # call it when a serve thread exists (or main() ran serve_forever inline)
        if self._serve_thread is not None:
            self.httpd.shutdown()
            self._serve_thread.join(timeout=10)
        self.httpd.server_close()

    def wait(self, job_id: str, timeout: float | None = None) -> _Job:
        with self._lock:
            job = self._jobs[job_id]
        if job.thread is not None:
            job.thread.join(timeout)
        return job


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="stellar-rw-tpu-serve", description="job-server entry point")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8090)
    ns = ap.parse_args(argv)
    srv = JobServer(ns.host, ns.port)
    print(f"serving on http://{srv.address[0]}:{srv.address[1]} "
          f"(POST /jobs with {{'{CONFIG_KEY}': '<argv string>'}})")
    try:
        srv.httpd.serve_forever()
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
