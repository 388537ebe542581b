"""The ambient mesh (``sharding.use_mesh``) is each thread's own, as
JAX's ``jax.sharding.set_mesh`` config context is.

Two threads hold different meshes under ``use_mesh`` at the same time
(a barrier keeps both inside their blocks while either computes): each
sees its own mesh in ``ambient_mesh()`` and in a reduced deepseek-v3
MoE layer under ``"dp"``, whose a2a groups its tokens by the ambient
mesh's axes (at capacity factor 1.25 the two meshes drop different
pairs, so a thread that read the other's mesh would give other bits).
"""
import concurrent.futures
import dataclasses
import threading

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import ShardMesh
from repro_torch.models import moe
from repro_torch.models.params import init_params

CPU = "cpu"
MESHES = (dict(data=2, model=2), dict(model=4))


def _cfg():
    cfg = dataclasses.replace(get_arch("deepseek-v3-671b").reduced,
                              compute_dtype="float32",
                              sharding_profile="dp")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25, impl="a2a"))


def _layer(cfg):
    params = init_params(moe.moe_specs(cfg), seed=0, device=CPU)
    x = torch.tensor(np.random.default_rng(0).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32))
    return params, x


def _moe(params, cfg, x):
    with torch.no_grad():
        y, _ = moe.moe_ffn(params, cfg, x)
    return y


def test_each_thread_sees_its_own_mesh():
    cfg = _cfg()
    params, x = _layer(cfg)
    meshes = [ShardMesh(device=CPU, axes=a) for a in MESHES]
    alone = []
    for mesh in meshes:
        with sharding.use_mesh(mesh):
            alone.append(_moe(params, cfg, x))
    assert sharding.ambient_mesh() is None
    assert not torch.equal(alone[0], alone[1]), \
        "the two meshes route alike: the check below would see nothing"

    barrier = threading.Barrier(len(meshes), timeout=60)

    def body(mesh):
        with sharding.use_mesh(mesh):
            barrier.wait()               # both threads hold their mesh
            seen = sharding.ambient_mesh()
            y = _moe(params, cfg, x)
            seen_after = sharding.ambient_mesh()
            barrier.wait()               # neither leaves before both ran
        return seen, seen_after, y, sharding.ambient_mesh()

    with concurrent.futures.ThreadPoolExecutor(len(meshes)) as pool:
        out = list(pool.map(body, meshes))
    for mesh, want, (seen, seen_after, y, left) in zip(meshes, alone, out):
        assert seen is mesh and seen_after is mesh
        assert left is None
        assert torch.equal(y, want), mesh
    assert sharding.ambient_mesh() is None


def test_a_thread_starts_with_no_ambient_mesh():
    """A mesh made ambient in one thread is not seen by a thread started
    inside its block."""
    mesh = ShardMesh(device=CPU, axes=MESHES[1])
    with sharding.use_mesh(mesh):
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            other = pool.submit(sharding.ambient_mesh).result()
        assert sharding.ambient_mesh() is mesh
    assert other is None
