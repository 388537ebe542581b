"""``benchmarks_torch/kernel_bench.py`` on the CPU: its counts against the
JAX kernel bench's, its migrate gate, and both sections at tiny sizes."""
import json

import numpy as np
import pytest

from benchmarks import kernel_bench as j_bench
from benchmarks_torch import kernel_bench as t_bench


@pytest.mark.parametrize("P,K", t_bench.SHAPES)
def test_counts_match_the_jax_script(P, K):
    """The JAX script's count (push round trip included) is copied
    unchanged; the bytes a sweep must move are 16 P + 13 P K."""
    assert t_bench.diffusion_numbers(P, K) == j_bench.diffusion_numbers(P, K)
    assert t_bench.sweep_bytes(P, K) == 16 * P + 13 * P * K


def test_bounds_at_the_four_shapes():
    """16 P + 13 P K bytes at 3.35 TB/s (the values rounded to 4
    figures)."""
    want = {(4096, 4): 0.00008314, (8192, 8): 0.0002934, (65536, 8): 0.002348,
            (1 << 20, 8): 0.03756}
    for (P, K), ms in want.items():
        got = t_bench.bound_ms(t_bench.sweep_bytes(P, K))
        assert abs(got - ms) <= 1e-3 * ms


def test_ring_graph_is_the_jax_scripts():
    """Hops +1..+K/2, then -1..-(K - K/2), as ``benchmarks/kernel_bench.py``
    builds them."""
    P, K = 16, 8
    nbr = t_bench.ring_graph(P, K)
    i = np.arange(P)
    for h in range(1, 5):
        np.testing.assert_array_equal(nbr[:, h - 1], (i + h) % P)
        np.testing.assert_array_equal(nbr[:, 3 + h], (i - h) % P)
    assert nbr.dtype == np.int32


def test_migrate_gate():
    row = dict(n=t_bench.GATE_N, sort_ms=2.0, scatter_ms=1.0, speedup=2.0)
    assert t_bench.migrate_gate([row])[0] is True
    slow = dict(row, scatter_ms=3.0, speedup=2.0 / 3.0)
    assert t_bench.migrate_gate([slow])[0] is False
    assert t_bench.migrate_gate([dict(row, n=4096)])[0] is None


def test_both_sections_run_on_the_cpu(tmp_path):
    out = tmp_path / "kb.json"
    assert t_bench.main(["--device", "cpu", "--shapes", "64:4,96:8",
                         "--sizes", "4096", "--reps", "2",
                         "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["environment"]["device"] == "cpu"
    assert [(r["P"], r["K"]) for r in res["diffusion"]] == [(64, 4), (96, 8)]
    for r in res["diffusion"]:
        assert r["agree"] and r["impl"] == "reference"
        assert set(r["sweep"]) == {"cpu_ms"}
        assert set(r["chunks"]) == {"selected", "streaming", "k1"}
        assert r["bytes"] == t_bench.sweep_bytes(r["P"], r["K"])
    (m,) = res["migrate"]
    assert m["n"] == 4096 and m["exact"] and "device_ms" not in m["sort"]
    assert res["migrate_gate"]["holds"] is None
