"""Interconnect topology model (port of ``repro.core.topology``).

The reference models a TPU pod as an ICI torus, with DCN between pods:

* a pod as a torus of chips, each chip with 2 ICI links per torus axis
  (bidirectional ring per row/column),
* multi-pod meshes as torus pods joined by DCN (per-chip share of pod-level
  DCN bandwidth),
* the **physical links themselves**: every directed ICI neighbour link per
  torus axis and every per-chip DCN uplink/downlink is enumerable
  (:meth:`MeshTopology.links`) and routable (:meth:`MeshTopology.route`), so
  a logical communication matrix can be projected onto the links that
  actually carry the bytes (:func:`repro_torch.core.comm_matrix.
  project_links`),
* hardware constants (:class:`HardwareSpec`), carried over as plain data so
  a report's per-tier times stay comparable with the reference's.
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

# sentinel device id for the inter-pod DCN fabric endpoint of a link
DCN_FABRIC = -1


@dataclasses.dataclass(frozen=True)
class Link:
    """One directed physical link.

    * ``kind == "ici"``: a torus neighbour link ``src -> dst`` along mesh
      axis ``axis`` (each chip has one per direction per axis).
    * ``kind == "dcn"``: a chip's share of the pod DCN connectivity.  The
      uplink is ``src=device, dst=DCN_FABRIC``; the downlink is
      ``src=DCN_FABRIC, dst=device``.  Cross-pod traffic is charged to the
      sender's uplink and the receiver's downlink (the fabric core is
      assumed non-blocking, so the chip shares are the contended resource).
    """

    kind: str                    # "ici" | "dcn"
    src: int                     # sending device, or DCN_FABRIC
    dst: int                     # receiving device, or DCN_FABRIC
    axis: str                    # torus axis name for ici; "dcn" otherwise

    @property
    def name(self) -> str:
        if self.kind == "dcn":
            if self.dst == DCN_FABRIC:
                return f"dcn:d{self.src}^"      # uplink
            return f"dcn:vd{self.dst}"          # downlink
        return f"ici:{self.axis}:d{self.src}>d{self.dst}"


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

    @classmethod
    def fleet(cls, num_devices: int, pod_side: int = 16,
              hw: HardwareSpec = V5E) -> "MeshTopology":
        """Synthetic fleet topology for scale curves
        (:mod:`repro_torch.scale`): up to ``pod_side**2`` devices is one 2D
        torus pod (squarest ``data x model`` factorization); beyond that, full
        ``pod_side x pod_side`` pods joined by a DCN ``pod`` axis --
        16384 devices is ``(64, 16, 16)`` over ``(pod, data, model)``.

        No device mesh exists at these device counts; this is the pure
        topology model the sparse matrix/link path is projected onto.
        """
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {num_devices}")
        pod = pod_side * pod_side
        if num_devices <= pod:
            side = max(1, math.isqrt(num_devices))
            while num_devices % side:
                side -= 1
            return cls(axis_names=("data", "model"),
                       axis_sizes=(num_devices // side, side), hw=hw)
        if num_devices % pod:
            raise ValueError(
                f"multi-pod fleet sizes must be multiples of {pod} "
                f"({pod_side}x{pod_side} pods), got {num_devices}")
        return cls(axis_names=("pod", "data", "model"),
                   axis_sizes=(num_devices // pod, pod_side, pod_side),
                   hw=hw)

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

    def is_dcn_axis(self, name: str) -> bool:
        return name in self.dcn_axes

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

    # ------------------------------------------------------------------
    # Physical links: enumeration and routing.
    # ------------------------------------------------------------------
    @property
    def ici_axes(self) -> tuple[str, ...]:
        """Torus axes (size > 1) that ride ICI, in mesh-axis order."""
        return tuple(n for n, s in zip(self.axis_names, self.axis_sizes)
                     if n not in self.dcn_axes and s > 1)

    def device_at(self, coords) -> int:
        device = 0
        for size, c in zip(self.axis_sizes, coords):
            device = device * size + (c % size)
        return device

    def neighbor(self, device: int, axis: str, step: int = 1) -> int:
        """Torus neighbour of ``device`` ``step`` hops along ``axis``."""
        i = self.axis_names.index(axis)
        coords = list(self.coords(device))
        coords[i] = (coords[i] + step) % self.axis_sizes[i]
        return self.device_at(coords)

    def pod_index(self, device: int) -> int:
        """Which pod (DCN tier) a device belongs to."""
        return self._pod_index(device)

    def links(self) -> list[Link]:
        """Every physical link: directed ICI neighbour links per torus axis
        plus, on multi-pod meshes, each chip's DCN uplink and downlink.

        A size-2 torus axis wraps both directions onto the same neighbour;
        the two physical cables collapse into one directed link per
        (src, dst) pair here, matching how traffic is charged in
        :meth:`route` (which emits exactly one hop for that neighbour).
        :meth:`link_multiplicity` records the 2 aggregated cables and
        :meth:`link_bandwidth` credits both, so the collapse never halves
        the pair's real capacity.
        """
        out: list[Link] = []
        seen: set[tuple] = set()
        for d in range(self.num_devices):
            for axis in self.ici_axes:
                for step in (1, -1):
                    nb = self.neighbor(d, axis, step)
                    key = ("ici", d, nb, axis)
                    if nb != d and key not in seen:
                        seen.add(key)
                        out.append(Link("ici", d, nb, axis))
        if self.num_pods > 1:
            for d in range(self.num_devices):
                out.append(Link("dcn", d, DCN_FABRIC, "dcn"))
                out.append(Link("dcn", DCN_FABRIC, d, "dcn"))
        return out

    def link_multiplicity(self, link: Link) -> int:
        """Physical cables aggregated into this directed :class:`Link`.

        1 for every link except an ICI link on a size-2 torus axis, where
        the +1 and -1 cables reach the *same* neighbour and collapse into
        one enumerated link carrying both cables' bandwidth.
        """
        if link.kind == "ici" and self.axis_size(link.axis) == 2:
            return self.hw.ici_links_per_axis
        return 1

    def link_bandwidth(self, link: Link) -> float:
        """Bytes/s one direction of this physical link sustains (both
        aggregated cables on a collapsed size-2 axis, see
        :meth:`link_multiplicity`)."""
        if link.kind == "dcn":
            return self.hw.dcn_bw_per_chip
        return self.hw.ici_bw * self.link_multiplicity(link)

    def torus_distance(self, src: int, dst: int) -> int:
        """Minimal ICI hop count between two same-pod devices: the sum over
        torus axes of the shorter way around each ring (wrap-aware)."""
        src_coords = self.coords(src)
        dst_coords = self.coords(dst)
        hops = 0
        for i, axis in enumerate(self.axis_names):
            size = self.axis_sizes[i]
            if axis in self.dcn_axes or size <= 1:
                continue
            delta = (dst_coords[i] - src_coords[i]) % size
            hops += min(delta, size - delta)
        return hops

    def route(self, src: int, dst: int) -> list[Link]:
        """Physical links a ``src -> dst`` transfer traverses.

        Within a pod: dimension-ordered torus routing, wrap-aware -- each
        axis takes the shorter way around its ring (ties at exactly half
        way go +1), so ``len(route(a, b)) == torus_distance(a, b)``.  On a
        size-2 axis both directions are the same single hop onto the
        collapsed neighbour link -- never two distinct hops.  Across pods:
        the sender's DCN uplink plus the receiver's DCN downlink (inter-pod
        traffic does not detour over ICI in this model).  Every emitted
        link is one of :meth:`links` -- :func:`repro_torch.core.comm_matrix.
        project_links` enforces this.
        """
        if src == dst:
            return []
        if self._pod_index(src) != self._pod_index(dst):
            return [Link("dcn", src, DCN_FABRIC, "dcn"),
                    Link("dcn", DCN_FABRIC, dst, "dcn")]
        hops: list[Link] = []
        cur = src
        cur_coords = list(self.coords(src))
        dst_coords = self.coords(dst)
        for i, axis in enumerate(self.axis_names):
            size = self.axis_sizes[i]
            if axis in self.dcn_axes or size <= 1:
                continue
            delta = (dst_coords[i] - cur_coords[i]) % size
            step = 1 if delta <= size - delta else -1
            while cur_coords[i] != dst_coords[i]:
                nxt = self.neighbor(cur, axis, step)
                hops.append(Link("ici", cur, nxt, axis))
                cur = nxt
                cur_coords[i] = (cur_coords[i] + step) % size
        return hops
