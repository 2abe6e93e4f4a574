"""Shared set-up of the port's tests (``tests/test_torch_*.py``).

The fake process group behind a monitored mesh is process-global: it is
made once per test process (each xdist worker is one) by :func:`mesh_4x2`
and reused, never torn down.
"""
import functools


@functools.lru_cache(maxsize=None)
def mesh_4x2():
    """A ``(data 4, model 2)`` ``DeviceMesh`` on CPU over the fake process
    group of 8 ranks."""
    from repro_torch.core import fake_mesh

    return fake_mesh((4, 2), ("data", "model"), device="cpu")
