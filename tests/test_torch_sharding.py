"""The port's ``Sharder`` (over a torch ``DeviceMesh``) against the
reference's (over a JAX mesh): the same logical-axis rules give the same
partition entries, with the divisibility fallback and no axis reuse, for
every parameter and cache leaf of Qwen3-8B (full and reduced) and for the
activation layouts the model asks for."""
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.compat import make_mesh
from repro.parallel import Sharder as RefSharder
from repro_torch import configs
from repro_torch.core import fake_mesh
from repro_torch.models import build_model
from repro_torch.parallel import Sharder
from torch_fixtures import mesh_4x2

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ACTIVATIONS = [
    ((8, 128, 4096), ("batch", "seq", None)),
    ((8, 128, 32, 128), ("batch", "seq", "heads", None)),
    ((8, 128, 8, 128), ("batch", "seq", "kv_heads", None)),
    ((6, 128, 3, 128), ("batch", "seq", "heads", None)),     # no divisor
    ((8, 1, 151936), ("batch", "seq", "vocab")),
    ((8, 128, 24576), ("batch", "seq", "mlp")),
    ((4, 4), ("embed", "embed")),                            # axis reuse
]


def _leaves(shapes, axes):
    if isinstance(shapes, dict):
        for k in shapes:
            yield from _leaves(shapes[k], axes[k])
    else:
        yield tuple(shapes.shape), axes


def _cases():
    out = list(ACTIVATIONS)
    for reduced in (False, True):
        model = build_model(configs.config("qwen3_8b", reduced=reduced))
        out += _leaves(model.shapes("meta"), model.axes())
        out += _leaves(model.cache_shapes(8, 160, "meta"), model.cache_axes())
    return out


def _port_mesh(name):
    mesh_4x2()                      # the process group, made once
    shape, names = MESHES[name]
    return fake_mesh(shape, names, device="cpu")


@pytest.mark.parametrize("name", list(MESHES))
def test_spec_matches_reference(name):
    shape, names = MESHES[name]
    ref = RefSharder(make_mesh(shape, names))
    port = Sharder(_port_mesh(name))
    for dims, axes in _cases():
        assert port.spec(dims, axes) == tuple(ref.spec(dims, axes)), \
            (dims, axes)
        for logical in ("batch", "heads", "embed"):
            assert port.logical_size(logical) == ref.logical_size(logical)


def test_placements_follow_the_spec():
    port = Sharder(_port_mesh("2x2x2"))
    assert port.placements((8, 128, 4096), ("batch", "seq", None)) == (
        Shard(0), Shard(0), Replicate())
    assert port.placements((4096, 4096), ("embed", "heads")) == (
        Replicate(), Shard(0), Shard(1))
    assert port.placements((6, 4096), ("batch", None)) == (
        Shard(0), Replicate(), Replicate())


def test_no_mesh_is_identity():
    import torch
    shd = Sharder()
    x = torch.ones(2, 3)
    assert shd.shard(x, ("batch", None)) is x
    assert shd.constraint(x, ("batch", None)) is x
    assert shd.local(lambda a: a + 1, (x,), (None,)).sum().item() == 12
    assert shd.logical_size("heads") == 1
