"""chip_smoke.py, the on-card smoke run: what it does where there is no card,
and the shape of the last line it prints where there is one."""

import json
import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def test_main_without_gpu_fails_and_prints_no_ok(capsys):
    rc = chip_smoke.main([])
    out = capsys.readouterr()
    assert rc != 0
    assert '"ok": true' not in out.out and '"ok"' not in out.out
    assert "no GPU" in out.err


def test_last_line_is_the_contract():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
            for _ in range(4)]
    line = chip_smoke.last_line(devs)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert json.loads(chip_smoke.last_line(devs[:1]))["device"]["count"] == 1


def test_sgns_tolerance_rejects_a_bf16_result(karate_path):
    """The card-vs-CPU SGNS gate passes a float32 rerun and fails the same
    epoch's table rounded to bf16: it can tell a reduced-precision update
    from a sound one."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from stellar_rw_tpu.graph import io
    from stellar_rw_tpu.walk import engine

    g = io.load_edge_list(karate_path, weighted=False)
    corpus = engine.random_walks(g, walk_length=80, num_walks=1, p=0.25,
                                 q=0.25, seed=0)
    cpu = jax.devices("cpu")[0]
    w, w0 = chip_smoke.sgns_train(corpus, g.num_vertices, cpu, 0, 0)
    again, _ = chip_smoke.sgns_train(corpus, g.num_vertices, cpu, 0, 0)
    ref = np.asarray(w, np.float64)
    sound = chip_smoke.compare_embeddings(np.asarray(again), ref, w0)
    assert sound["max_rel_update"] <= chip_smoke.SGNS_TOL
    bf16 = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
    rounded = chip_smoke.compare_embeddings(bf16, ref, w0)
    assert rounded["max_rel_update"] > 10 * chip_smoke.SGNS_TOL, rounded
