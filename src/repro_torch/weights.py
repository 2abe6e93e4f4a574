"""Hand the reference's parameters to the port.

``from_jax_params`` takes the pytree that ``repro``'s ``model.init(...)``
returns for any ported model, already converted to numpy
(``jax.tree.map(np.asarray, params)``), and gives the port's parameter
dict, leaf for leaf against the specs of
:func:`repro_torch.models.build_model`.  The port keeps the reference's names,
its stacked ``(L, ...)`` leading dim and its ``(in, out)`` matrix layout, so
no leaf is transposed: ``mlp.wi`` stays gate-then-up along its last dim (the
port's ``torch.chunk(h, 2)`` splits it in the same order), and ``wq/wk/wv``
keep their ``(head, dh)`` column order (the port reshapes to heads the way
the reference does).  The function checks every leaf's shape against the
port's own specs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import build_model
from repro_torch.models.common import ModelConfig


def from_jax_params(tree, cfg: ModelConfig, device="cuda",
                    dtype=None) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device`` (the GPU unless the caller passes ``"cpu"``; ``dtype``: keep
    each leaf's own dtype when None)."""
    specs = build_model(cfg).specs()

    def convert(node, spec, path):
        if isinstance(spec, dict):
            if set(node) != set(spec):
                raise KeyError(f"{'/'.join(path) or '<root>'}: keys "
                               f"{sorted(node)} != {sorted(spec)}")
            return {k: convert(node[k], spec[k], path + (k,)) for k in spec}
        arr = np.asarray(node)
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != "
                             f"{spec.shape}")
        if arr.dtype.name == "bfloat16":      # ml_dtypes bf16
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))   # a writable copy
        return t.to(device=device, dtype=dtype or t.dtype)

    return convert(tree, specs, ())
