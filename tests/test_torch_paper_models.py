"""The paper's applications in the port (``repro_torch.models.resnet``,
``.gnmt``, ``repro_torch.data``) against the JAX package.

The reference's weights go across through
:func:`repro_torch.weights.from_jax_params`; inputs are the synthetic
batches, made by numpy in both packages.  Everything is fp32 on the CPU.
Tolerances: the loss to ``1e-5`` relative, every gradient leaf to
``1e-4 * max|ref|`` of that leaf (fp32 convolutions, matmuls and a 6-step
recurrence summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data import synthetic as ref_data
from repro.models.gnmt import GNMT as RefGNMT
from repro.models.resnet import ResNet18 as RefResNet18
from repro.models.resnet import _conv as ref_conv
from repro_torch.data import synthetic as data
from repro_torch.models import GNMT, ResNet18
from repro_torch.models.common import _leaves, tree_leaves, tree_unflatten
from repro_torch.models.resnet import _conv
from repro_torch.train.ddp import value_and_grad
from repro_torch.weights import from_jax_params

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _check_loss_and_grads(rmodel, pmodel, seed, batch):
    rparams = rmodel.init(jax.random.PRNGKey(seed))
    pparams = from_jax_params(jax.tree.map(np.asarray, rparams), pmodel,
                              device="cpu")
    (rloss, _), rgrads = jax.value_and_grad(rmodel.loss_fn, has_aux=True)(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    (ploss, _), pgrads = value_and_grad(pmodel.loss_fn, pparams,
                                        _to_torch(batch))
    assert float(ploss) == pytest.approx(float(rloss), rel=LOSS_RTOL)
    flat_ref = jax.tree_util.tree_leaves_with_path(rgrads)
    flat_port = list(_leaves(pgrads))
    assert len(flat_ref) == len(flat_port)
    for (rpath, rg), (ppath, pg) in zip(flat_ref, flat_port):
        assert [getattr(k, "key", getattr(k, "idx", None))
                for k in rpath] == list(ppath)
        rg = np.asarray(rg)
        np.testing.assert_allclose(
            pg.numpy(), rg, rtol=0,
            atol=GRAD_TOL * max(np.abs(rg).max(), 1e-30),
            err_msg="/".join(map(str, ppath)))


def test_resnet18_loss_and_grads():
    """10 classes, 32x32 images: stages 2-4 open with a stride-2 block, so
    the asymmetric SAME padding and the 1x1 stride-2 projection run."""
    batch = ref_data.SyntheticImageData(
        num_classes=10, global_batch=4, image_size=32).batch_at(0)
    _check_loss_and_grads(RefResNet18(num_classes=10), ResNet18(10), 0,
                          jax.tree.map(np.asarray, batch))


def test_gnmt_loss_and_grads():
    """vocab 64, d 32, 2 layers, source and target length 6; a masked label
    (below 0) takes no part in the loss."""
    batch = jax.tree.map(np.array, ref_data.SyntheticSeq2Seq(
        vocab_size=64, src_len=6, tgt_len=6, global_batch=3).batch_at(1))
    batch["labels"][0, -2:] = -1
    _check_loss_and_grads(RefGNMT(64, 32, 2), GNMT(64, 32, 2), 1, batch)


@settings(max_examples=12, deadline=None)
@given(size=st.integers(3, 9), k=st.sampled_from([1, 3]),
       stride=st.sampled_from([1, 2]))
def test_conv_pads_as_xla_same(size, k, stride):
    """``_conv`` against the reference's ``SAME`` convolution, on even and
    odd inputs, at strides 1 and 2."""
    rng = np.random.default_rng(size * 10 + k)
    x = rng.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    want = np.asarray(ref_conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = _conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w),
                stride).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("model", [ResNet18(10), GNMT(64, 32, 2)],
                         ids=["resnet18", "gnmt"])
def test_leaf_order_is_jax_flatten_order(model):
    """Lists walk in index order and dict keys sorted: the order that
    fixes the gradient bucket plan."""
    ref = (RefResNet18(10) if isinstance(model, ResNet18)
           else RefGNMT(64, 32, 2))
    ref_paths = [tuple(getattr(k, "key", getattr(k, "idx", None))
                       for k in path) for path, _ in
                 jax.tree_util.tree_leaves_with_path(ref.shapes())]
    assert [p for p, _ in _leaves(model.specs())] == ref_paths
    shapes = model.shapes(device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(shapes)] == [
        s.shape for s in jax.tree.leaves(ref.shapes())]
    # unflatten inverts flatten, lists and all
    back = tree_unflatten(shapes, tree_leaves(shapes))
    assert all(a is b for a, b in zip(tree_leaves(back),
                                      tree_leaves(shapes)))
    assert isinstance(back["stages" if "stages" in back else "enc"], list)


def test_weights_reject_a_wrong_list_or_shape():
    tree = jax.tree.map(np.asarray, RefGNMT(64, 32, 2).init(
        jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="list of 3"):
        from_jax_params(tree, GNMT(64, 32, 3), device="cpu")
    tree["dec"][1]["wh"] = tree["dec"][1]["wh"][:, :-1]
    with pytest.raises(ValueError, match="dec/1/wh"):
        from_jax_params(tree, GNMT(64, 32, 2), device="cpu")


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1)])
def test_synthetic_batches_bit_equal(seed, step):
    """Both pipelines draw the same numpy streams: equal values, dtypes
    and logged host transfers."""
    pairs = [
        (ref_data.SyntheticImageData(num_classes=10, global_batch=4,
                                     image_size=8, seed=seed),
         data.SyntheticImageData(num_classes=10, global_batch=4,
                                 image_size=8, seed=seed)),
        (ref_data.SyntheticSeq2Seq(vocab_size=64, src_len=7, tgt_len=5,
                                   global_batch=3, seed=seed),
         data.SyntheticSeq2Seq(vocab_size=64, src_len=7, tgt_len=5,
                               global_batch=3, seed=seed)),
    ]
    for ref, port in pairs:
        n_ref, n_port = (len(ref_data.host_transfer_log()),
                         len(data.host_transfer_log()))
        want, got = ref.batch_at(step), port.batch_at(step, device="cpu")
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype
        new_ref = ref_data.host_transfer_log()[n_ref:]
        new_port = data.host_transfer_log()[n_port:]
        assert [(t.direction, t.device, t.nbytes, t.label)
                for t in new_port] == [(t.direction, t.device, t.nbytes,
                                        t.label) for t in new_ref]
