"""Hand the reference's parameters to the port.

``from_jax_params`` takes the pytree that ``repro``'s ``model.init(...)``
returns for any ported model, already converted to numpy
(``jax.tree.map(np.asarray, params)``), and gives the port's parameter
tree, leaf for leaf against the port's own specs: those of
:func:`repro_torch.models.build_model` for a ``ModelConfig``, of the model
itself for a :class:`~repro_torch.models.ResNet18` or
:class:`~repro_torch.models.GNMT`, or a spec tree as given.  The port keeps
the reference's names, its lists (ResNet's stages, GNMT's layers), its
stacked ``(L, ...)`` leading dim, its ``(in, out)`` matrix layout and its
HWIO convolutions, so no leaf is transposed: ``mlp.wi`` stays
gate-then-up along its last dim (the port's ``torch.chunk(h, 2)`` splits
it in the same order), and ``wq/wk/wv`` keep their ``(head, dh)`` column
order (the port reshapes to heads the way the reference does).  The
function checks every leaf's shape against the specs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import build_model
from repro_torch.models.common import ModelConfig


def from_jax_params(tree, model, device="cuda", dtype=None):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors on
    ``device`` (the GPU unless the caller passes ``"cpu"``; ``dtype``: keep
    each leaf's own dtype when None).  ``model``: a ``ModelConfig``, a model
    with ``specs()``, or a spec tree."""
    if isinstance(model, ModelConfig):
        model = build_model(model)
    specs = model.specs() if hasattr(model, "specs") else model

    def convert(node, spec, path):
        where = "/".join(map(str, path)) or "<root>"
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                raise KeyError(f"{where}: want the keys {sorted(spec)}")
            return {k: convert(node[k], spec[k], path + (k,)) for k in spec}
        if isinstance(spec, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(spec):
                raise ValueError(f"{where}: want a list of {len(spec)}")
            return [convert(n, s, path + (i,))
                    for i, (n, s) in enumerate(zip(node, spec))]
        arr = np.asarray(node)
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{where}: shape {arr.shape} != {spec.shape}")
        if arr.dtype.name == "bfloat16":      # ml_dtypes bf16
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))   # a writable copy
        return t.to(device=device, dtype=dtype or t.dtype)

    return convert(tree, specs, ())
