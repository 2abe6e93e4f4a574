"""Interconnect topology model (port of ``repro.core.topology``).

The reference models a TPU pod as an ICI torus, with DCN between pods:

* a pod as a torus of chips, each chip with 2 ICI links per torus axis
  (bidirectional ring per row/column),
* multi-pod meshes as torus pods joined by DCN (per-chip share of pod-level
  DCN bandwidth),
* hardware constants (:class:`HardwareSpec`), carried over as plain data so
  a report's per-tier times stay comparable with the reference's.

The physical-link enumeration and routing (``Link``, ``links``, ``route``)
wait for the port's link slice.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12      # FLOP/s per chip
    hbm_bw: float = 819e9                # bytes/s per chip
    ici_bw: float = 50e9                 # bytes/s per link, per direction
    ici_links_per_axis: int = 2          # bidirectional ring: +1/-1 neighbours
    dcn_bw_per_chip: float = 6.25e9      # bytes/s per chip across pods
    hbm_per_chip: int = 16 * 1024**3     # bytes
    # per-hop latency terms (small-payload regime): one ICI neighbour hop
    # vs one DCN exchange -- charged per schedule-phase ``latency_hops`` by
    # ``cost_models.collective_time_split``
    ici_hop_latency_s: float = 1e-6      # seconds per ICI ring hop
    dcn_hop_latency_s: float = 25e-6     # seconds per cross-pod DCN hop


V5E = HardwareSpec()

@dataclasses.dataclass
class MeshTopology:
    """Logical mesh axes mapped onto the physical torus.

    ``axis_names``/``axis_sizes`` follow the device mesh.  Axes named "pod" (or
    listed in ``dcn_axes``) cross DCN; all other axes ride ICI.
    """

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    hw: HardwareSpec = V5E
    dcn_axes: tuple[str, ...] = ("pod",)

    @classmethod
    def from_mesh(cls, mesh, hw: HardwareSpec = V5E, dcn_axes=("pod",)):
        """From a torch ``DeviceMesh`` (its ``mesh_dim_names`` and shape)."""
        return cls.from_shape(tuple(mesh.shape), mesh.mesh_dim_names,
                              hw=hw, dcn_axes=dcn_axes)

    @classmethod
    def from_shape(cls, shape, axis_names, hw: HardwareSpec = V5E,
                   dcn_axes=("pod",)):
        """From a mesh shape and its axis names, e.g. ``((4, 2), ("data",
        "model"))``."""
        return cls(axis_names=tuple(axis_names),
                   axis_sizes=tuple(int(n) for n in shape),
                   hw=hw, dcn_axes=tuple(dcn_axes))

    @property
    def num_devices(self) -> int:
        return int(math.prod(self.axis_sizes))

    @property
    def devices_per_pod(self) -> int:
        n = self.num_devices
        for name, size in zip(self.axis_names, self.axis_sizes):
            if name in self.dcn_axes:
                n //= size
        return n

    @property
    def num_pods(self) -> int:
        return self.num_devices // self.devices_per_pod

    def axis_size(self, name: str) -> int:
        return self.axis_sizes[self.axis_names.index(name)]

    # ------------------------------------------------------------------
    # Bandwidth available to one chip for a collective along a set of devices.
    # A ring along an ICI mesh axis uses both directions of that axis' links.
    # ------------------------------------------------------------------
    def ring_bw_per_chip(self, crosses_dcn: bool) -> float:
        if crosses_dcn:
            return self.hw.dcn_bw_per_chip
        return self.hw.ici_bw * self.hw.ici_links_per_axis

    def group_crosses_dcn(self, group: list[int]) -> bool:
        """Does a replica group (global device ids) span multiple pods?

        Device ids enumerate the mesh in row-major order of ``axis_sizes``
        (``DeviceMesh`` convention), so a group crosses DCN iff members
        differ in their coordinate on a DCN axis.
        """
        if self.num_pods == 1 or not group:
            return False
        pod_of = [self._pod_index(d) for d in group]
        return len(set(pod_of)) > 1

    def pod_partition(self, group: list[int]) -> list[list[int]]:
        """Split a replica group into per-pod subgroups (member order kept).

        The hierarchical all-reduce placement and cost model both decompose
        a cross-DCN group this way: ring phases inside each subgroup, a
        cross-pod exchange between same-index members of the subgroups.
        """
        by_pod: dict[int, list[int]] = {}
        for d in group:
            by_pod.setdefault(self._pod_index(d), []).append(d)
        return [by_pod[k] for k in sorted(by_pod)]

    def _pod_index(self, device: int) -> int:
        coords = []
        rem = device
        for size in reversed(self.axis_sizes):
            coords.append(rem % size)
            rem //= size
        coords.reverse()
        pod = 0
        for name, c in zip(self.axis_names, coords):
            if name in self.dcn_axes:
                pod = pod * self.axis_size(name) + c
        return pod

    def coords(self, device: int) -> tuple[int, ...]:
        coords = []
        rem = device
        for size in reversed(self.axis_sizes):
            coords.append(rem % size)
            rem //= size
        return tuple(reversed(coords))

    def pod_index(self, device: int) -> int:
        """Which pod (DCN tier) a device belongs to."""
        return self._pod_index(device)
