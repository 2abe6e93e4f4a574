"""Logical-axis sharding over a torch ``DeviceMesh`` (port of
``repro.parallel.sharding``).

Every parameter/activation dimension carries a *logical* axis name
(``"embed"``, ``"heads"``, ``"vocab"``...).  A :class:`Sharder` binds those
to mesh axes through the same rules table as the reference, with its two
rules: a logical dim is sharded only if its size divides the mapped
mesh-axes product (prefix fallback otherwise), and no mesh axis is reused
within one tensor.  The result maps to DTensor placements: ``Shard(d)`` on
each mesh dim that a tensor dim claims, ``Replicate()`` elsewhere.

``enable_sp`` maps ``seq`` to ``model`` (sequence parallelism), as the
reference's does; a sequence that ``model`` does not divide (a decode
step's one token) stays whole.  What the rules table cannot say about a
split sequence lives here too: the global offset of a rank's shard
(:meth:`Sharder.seq_offset`), the product of a sequence-split activation
with a weight (:meth:`Sharder.matmul`) and its last position
(:meth:`Sharder.last_position`).  With no mesh (serving on one card)
every method is the identity and the model runs on plain tensors.  With
a mesh, tensors are DTensors, ``constraint`` is ``redistribute``, and
:meth:`Sharder.local` runs a function -- a kernel wrapper, which has no
DTensor sharding rule -- on the local shards.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# logical axis -> tuple of mesh axes (in sharding-priority order)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("data",),          # FSDP
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "rnn": ("model",),
    "inner": ("model",),
    "kv_seq": ("model",),
    "attn_seq": ("model",),
    "seq": (),
    "layers": (),
    "conv": (),
    "stack": (),
}


class Sharder:
    """Binds logical axes to a ``DeviceMesh`` (or to nothing: one card)."""

    def __init__(self, mesh=None, rules: Optional[dict] = None,
                 enable_sp: bool = False):
        self.mesh = mesh
        self.rules = dict(rules or DEFAULT_RULES)
        if enable_sp:
            self.rules["seq"] = ("model",)
        self.mesh_sizes: dict[str, int] = (
            dict(zip(mesh.mesh_dim_names, mesh.shape))
            if mesh is not None else {})

    # ------------------------------------------------------------------
    def axis_size(self, mesh_axis: str) -> int:
        return self.mesh_sizes.get(mesh_axis, 1)

    def logical_size(self, logical: str) -> int:
        """Product of mesh axes a logical name maps to (1 if unmapped)."""
        axes = [a for a in self.rules.get(logical, ())
                if a in self.mesh_sizes]
        return int(math.prod(self.mesh_sizes[a] for a in axes)) if axes else 1

    @property
    def tp(self) -> int:
        return self.axis_size("model")

    @property
    def dp(self) -> int:
        return self.logical_size("batch")

    def coordinate(self, mesh_axis: str) -> int:
        """This rank's coordinate on ``mesh_axis`` (0 without a mesh or
        that axis)."""
        if mesh_axis not in self.mesh_sizes:
            return 0
        return self.mesh.get_local_rank(mesh_axis)

    def group(self, mesh_axis: str):
        """The process group of ``mesh_axis``: the ranks that share every
        other coordinate with this one (what a collective over that axis
        runs on)."""
        return self.mesh.get_group(mesh_axis)

    # ------------------------------------------------------------------
    # sequence parallelism
    # ------------------------------------------------------------------
    def seq_offset(self, s: int, logical: str = "seq") -> int:
        """Global position of this rank's first row of a sequence of ``s``
        laid out by ``logical``: its coordinate over the mapped mesh axes
        (row-major) times the shard's length; 0 where the sequence is
        whole."""
        entry = self.spec((s,), (logical,))[0] if self.mesh is not None \
            else None
        if entry is None:
            return 0
        idx, n = 0, 1
        for a in ((entry,) if isinstance(entry, str) else entry):
            idx = idx * self.mesh_sizes[a] + self.coordinate(a)
            n *= self.mesh_sizes[a]
        return idx * (s // n)

    def seq_sharded(self, x) -> bool:
        """Whether activation ``x`` (B, S, ...) is a DTensor split along
        its sequence (dim 1)."""
        if self.mesh is None:
            return False
        from torch.distributed.tensor import DTensor, Shard

        return isinstance(x, DTensor) and any(
            isinstance(p, Shard) and p.dim == 1 for p in x.placements)

    def matmul(self, x, w):
        """``x @ w`` for an activation ``x`` and a weight ``w`` (in, out).

        Where ``x`` is split along its sequence (the ``seq -> model``
        rule), the weight's output dim has lost ``model`` to the sequence
        (no axis reuse), and DTensor has no strategy for a product of the
        flattened batch-and-sequence shards with a split weight: ``w`` is
        gathered whole and the product taken on the local rows.  Its
        gradient is each rank's share (``Partial`` where the rows are
        split), reduced back to the weight's shards.  Elsewhere this is
        ``x @ w``."""
        if not self.seq_sharded(x):
            return x @ w
        return self.local(torch.matmul, (x, w), (None, (None,) * w.dim()))

    def last_position(self, x):
        """``x[:, -1:]``, contiguous (the kernels take contiguous rows).
        Where ``x`` is split along its sequence, each rank's last row is
        taken on its shard first, so only those rows are gathered, not
        the sequence."""
        if self.seq_sharded(x):
            x = self.local(lambda t: t[:, -1:], (x,), (None,))
        return x[:, -1:].contiguous()

    # ------------------------------------------------------------------
    def spec(self, shape: Sequence[int],
             axes: Sequence[Optional[str]]) -> tuple:
        """Mesh axes per tensor dim (the reference's PartitionSpec entries:
        ``None``, one axis name, or a tuple of names), divisibility-aware,
        no axis reuse."""
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} vs axes {tuple(axes)}")
        used: set[str] = set()
        entries = []
        for dim, logical in zip(shape, axes):
            if logical is None:
                entries.append(None)
                continue
            mesh_axes = [a for a in self.rules.get(logical, ())
                         if a in self.mesh_sizes and a not in used]
            while mesh_axes and dim % math.prod(
                    self.mesh_sizes[a] for a in mesh_axes) != 0:
                mesh_axes.pop()
            if not mesh_axes:
                entries.append(None)
                continue
            used.update(mesh_axes)
            entries.append(tuple(mesh_axes) if len(mesh_axes) > 1
                           else mesh_axes[0])
        return tuple(entries)

    def placements(self, shape, axes) -> tuple:
        """DTensor placements (one per mesh dim) for a tensor's axes."""
        from torch.distributed.tensor import Replicate, Shard

        by_mesh = {}
        for d, entry in enumerate(self.spec(shape, axes)):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                by_mesh[a] = Shard(d)
        return tuple(by_mesh.get(name, Replicate())
                     for name in self.mesh.mesh_dim_names)

    # ------------------------------------------------------------------
    def shard(self, x: torch.Tensor, axes):
        """A whole (global) tensor -> a DTensor laid out by ``axes``; the
        identity without a mesh.  No data moves between ranks: each keeps
        its own slice."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(x, self.mesh, self.placements(x.shape, axes),
                                 src_data_rank=None)

    def shard_tree(self, tree, axes_tree):
        """:meth:`shard` over a nested dict of tensors and its axes."""
        if isinstance(tree, dict):
            return {k: self.shard_tree(v, axes_tree[k])
                    for k, v in tree.items()}
        return self.shard(tree, axes_tree)

    def constraint(self, x, axes):
        """Redistribute ``x`` to the layout ``axes`` names (identity
        without a mesh)."""
        if self.mesh is None:
            return x
        return x.redistribute(self.mesh, self.placements(x.shape, axes))

    def local(self, fn, args, axes, out=0, out_placements=None,
              grad_placements=None):
        """``fn(*args)`` on local shards.

        ``axes[i]`` is the logical layout ``args[i]`` is redistributed to
        first (``None``: as it already is; plain tensors and non-tensors
        pass through).  Each output takes the placements of ``args[j]``
        for ``j`` in ``out`` (an int for one output, a tuple for several),
        or, given ``out_placements``, those (a list for one output, a tuple
        of lists for several).  ``grad_placements`` (one entry an
        argument, None to keep its input placements) says how each local
        input's gradient is laid out: ``Partial()`` on a mesh dim where the
        input is replicated but the ranks' work differs (a weight read by
        each batch shard), so the backward reduces it.  Not given, it is
        worked out by that rule (:func:`grad_placements_for`): an input
        replicated on a mesh dim that shards an output takes ``Partial()``
        there.  Without a mesh this is ``fn(*args)``.
        """
        if self.mesh is None:
            return fn(*args)
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import local_map

        in_pl = []
        for x, ax in zip(args, axes):
            if not isinstance(x, DTensor):
                in_pl.append(None)
            elif ax is None:
                in_pl.append(list(x.placements))
            else:
                in_pl.append(list(self.placements(x.shape, ax)))
        # local_map reads a list as one output's placements, a tuple as
        # one entry per output
        if out_placements is not None:
            out_pl = out_placements
        else:
            out_pl = (in_pl[out] if isinstance(out, int)
                      else tuple(in_pl[j] for j in out))
        if grad_placements is not None:
            grad_pl = [g if g is not None else p
                       for g, p in zip(grad_placements, in_pl)]
        else:
            grad_pl = grad_placements_for(in_pl, out_pl)
        return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                         in_grad_placements=grad_pl,
                         redistribute_inputs=True,
                         device_mesh=self.mesh)(*args)


def grad_placements_for(in_pl: list, out_pl) -> list:
    """Each local input's gradient placements, worked out from the input
    and output placements of a :meth:`Sharder.local` step (``in_pl`` one
    list a DTensor input, None for the others; ``out_pl`` one output's
    list or a tuple of them, None for a non-tensor output).

    Where an input is ``Replicate`` on a mesh dim that shards an output,
    each rank's work there differs (a weight read by its own batch rows,
    a kv head read by its own query heads), so its local gradient is one
    rank's share: ``Partial()`` on that dim, which the backward sums.
    Every other dim keeps the input's placement.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard

    outs = [out_pl] if isinstance(out_pl, list) else list(out_pl or ())
    sharded = {i for pl in outs if pl is not None
               for i, p in enumerate(pl) if isinstance(p, Shard)}
    return [None if pl is None else
            [Partial() if i in sharded and isinstance(p, Replicate) else p
             for i, p in enumerate(pl)]
            for pl in in_pl]
