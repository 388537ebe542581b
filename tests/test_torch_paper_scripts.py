"""The port's paper scripts (``benchmarks_torch/``) against the JAX
package on the CPU, at reduced sizes: their assertions hold and their
integer results equal JAX's."""
import numpy as np

from repro.core import api as j_api
from repro.sim import stencil as j_stencil
from repro.sim import synthetic as j_syn
from repro.sim import viz as j_viz

CPU = "cpu"


def test_table1_reduced_matches_jax():
    """The port's Table I at ring 32 × 8, 8 PEs: its assertions hold and
    ``diffusion_iters`` and assignments equal JAX's for every K."""
    from benchmarks_torch import table1_neighbor_count as t1

    out = t1.run(nx=32, ny=8, pes=8, device=CPU)
    jp = j_syn.hotspot(j_stencil.stencil_2d(32, 8, 8, mapping="ring"),
                       node=0, factor=10.0)
    for k in (1, 2, 4, 8):
        plan = j_api.run_strategy("diff-comm", jp, k=k)
        assert out["cells"][k]["diffusion_iters"] == \
            plan.info["diffusion_iters"]
        np.testing.assert_array_equal(out["assignments"][k], plan.assignment)


def test_fig2_reduced_matches_jax():
    from benchmarks_torch import fig2_stencil as f2

    out = f2.run(grid=24, pes=9, device=CPU)
    jp = j_syn.random_pm(j_stencil.stencil_2d(24, 24, 9, mapping="tiled"),
                         0.4, seed=1)
    for variant in ("diff-comm", "diff-coord"):
        plan = j_api.run_strategy(variant, jp, k=4)
        for k in ("max_avg_load", "ext_int_comm", "pct_migrations",
                  "diffusion_iters"):
            np.testing.assert_allclose(out[variant][k], plan.info[k],
                                       rtol=1e-6)
        assert out[variant + "_locality"] == \
            j_viz.locality_summary(plan.assignment, 24, 24)
