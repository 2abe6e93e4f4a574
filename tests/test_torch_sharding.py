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


def test_sequence_split_helpers():
    """The sequence-parallel helpers: a shard's global offset is its
    ``model`` coordinate times the shard's length where ``seq`` is split
    (``enable_sp`` and a length ``model`` divides), else 0 (a decode
    step's one token, or no ``enable_sp``: ``attn_seq`` alone splits
    then); without a mesh ``matmul`` and ``last_position`` are the plain
    product and slice."""
    import types

    import torch

    mesh = types.SimpleNamespace(
        mesh_dim_names=("data", "model"), shape=(4, 2),
        get_local_rank=lambda axis: {"data": 3, "model": 1}[axis])
    sp, plain = Sharder(mesh, enable_sp=True), Sharder(mesh)
    assert sp.seq_offset(32) == 16 and sp.seq_offset(1) == 0
    assert sp.seq_offset(33) == 0
    assert plain.seq_offset(32) == 0
    assert plain.seq_offset(32, "attn_seq") == 16
    shd = Sharder()
    x, w = torch.randn(2, 5, 3), torch.randn(3, 4)
    assert not shd.seq_sharded(x)
    assert torch.equal(shd.matmul(x, w), x @ w)
    last = shd.last_position(x)
    assert torch.equal(last, x[:, -1:]) and last.is_contiguous()


def test_seq_sharded_reads_the_placements():
    """An activation laid out ``("batch", "seq", None)`` is split along
    its sequence only under ``enable_sp``."""
    import torch

    x = torch.empty(8, 32, 16)
    for enable, want in ((False, False), (True, True)):
        shd = Sharder(mesh_4x2(), enable_sp=enable)
        assert shd.seq_sharded(shd.shard(x, ("batch", "seq", None))) == want
