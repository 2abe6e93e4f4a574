"""Production meshes (port of ``repro.launch.mesh``).

Single pod : (data=16, model=16)            = 256 ranks
Multi-pod  : (pod=2, data=16, model=16)     = 512 ranks; "pod" crosses DCN

Both are ``DeviceMesh``es over the fake process group
(:func:`repro_torch.core.fake_mesh`): nothing is allocated and no NCCL call
runs.  That group is process-global and refuses a second world size, so
the single-pod and the multi-pod mesh live in separate processes (the
reference slices both out of one pool of 512 host devices).  Defined as
functions, so importing this module makes no process group.
"""
from __future__ import annotations

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def production_layout(multi_pod: bool = False) -> tuple:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return MULTI_POD, ("pod", "data", "model")
    return SINGLE_POD, ("data", "model")


def make_production_mesh(multi_pod: bool = False, device: str = "cuda"):
    """The production mesh, on fake ranks of ``device``'s type."""
    from repro_torch.core import fake_mesh

    return fake_mesh(*production_layout(multi_pod), device=device)


def make_test_mesh(shape=(4, 2), axes=("data", "model"), device: str = "cpu"):
    """Small mesh for tests and examples, on fake ranks."""
    from repro_torch.core import fake_mesh

    return fake_mesh(shape, axes, device=device)


def mesh_name(mesh) -> str:
    """``"16x16:data,model"``: the sizes, then the axis names."""
    return "x".join(str(s) for s in mesh.shape) + ":" + \
        ",".join(mesh.mesh_dim_names)
