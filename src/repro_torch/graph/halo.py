"""Halo (cut-edge) exchange plans and device-executable exchange programs —
a numpy copy of the JAX package's ``graph/halo.py``; both give identical
arrays and byte counts.

GGS — the expensive baseline — must fetch, for every local node, the features
of its out-of-partition neighbors (the *halo*) every step.  The server
correction in LLCG needs the same data, but only S times per round.  Two
representations cover the two uses:

* :class:`HaloPlan` — host-side description: which remote nodes each machine
  needs and the extended local graph (cut-edges restored) to splice them
  into.  Reports exactly the byte counts plotted in Figure 2(b) / Table 1
  ("Avg. MB").
* :class:`HaloProgram` — the same exchange lowered to padded, rectangular
  index tables so the round engine (:mod:`repro_torch.core.engine`) can
  EXECUTE it on device each step: owner-bucketed send slots padded to the
  mesh-wide max (``max_send``) make the exchange one fixed-shape all-gather
  over the machines followed by a gather + scatter
  (:func:`repro_torch.core.machine.halo_fill`).

:func:`halo_exchange_reference` is the numpy oracle the padded program is
checked against.

Inference-time entry points: :func:`build_inference_plan` grows the halo to
the FULL L-hop closure of each machine's local set (induced subgraph, so an
L-layer forward over the extended view reproduces the single-machine
full-graph forward exactly for every local node), and
:func:`cut_crossing_mask` marks the nodes whose L-hop neighborhood crosses
a partition cut.  Both feed the SAME :func:`build_halo_program` lowering the
training engine executes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.graph.csr import (
    CSRGraph, gather_spans, neighbor_spans, subgraph_csr,
)
from repro_torch.graph.partition import Partition


def _itemsize(dtype) -> int:
    return int(np.dtype(dtype).itemsize)


@dataclasses.dataclass
class HaloPlan:
    """Per-machine halo exchange description.

    For machine p:
      halo_nodes[p]   — original ids of remote nodes whose features p needs.
      halo_owner[p]   — owning machine of each halo node.
      ext_graph[p]    — local graph over [local nodes ++ halo nodes] with
                        cut-edges RESTORED, reindexed (local first, halo after).
      ext_num_local[p] — number of local nodes (halo ids start here).
    """

    halo_nodes: List[np.ndarray]
    halo_owner: List[np.ndarray]
    ext_graphs: List[CSRGraph]
    ext_num_local: List[int]

    def halo_bytes(self, feature_dim: int, dtype=np.float32,
                   compression: str = "none") -> int:
        """Ideal bytes moved per full halo exchange (all machines, one
        direction): every machine receives exactly its halo rows, no
        padding, no broadcast.  ``dtype`` is the feature dtype the bytes
        are derived from (f32 features ⇒ 4 B/element); ``compression``
        prices the wire format of :mod:`repro_torch.comm.compress` (int8 rows
        carry a 4-byte f32 scale each)."""
        from repro_torch.comm.compress import wire_row_bytes
        return int(sum(int(h.size) for h in self.halo_nodes)
                   * wire_row_bytes(feature_dim, dtype, compression))


def ext_fanout(plan: HaloPlan, base_fanout: int) -> int:
    """Neighbor-table width for the extended (cut-edges-restored) graphs.

    Full extended-graph degree, capped at 4× the (floored) base fanout —
    the one rule every GGS path (simulation, sharded runtime, dry-run)
    shares so their lowered table shapes agree.
    """
    md = max(max(g.max_degree() for g in plan.ext_graphs), 1)
    return min(md, max(int(base_fanout), 8) * 4)


def build_halo_plan(graph: CSRGraph, partition: Partition) -> HaloPlan:
    src, dst = graph.to_edges()
    asg = partition.assignment
    halo_nodes, halo_owner, ext_graphs, ext_num_local = [], [], [], []
    for p in range(partition.num_parts):
        local = partition.part_nodes[p]
        n_local = local.size
        # remote endpoints of cut edges incident to p
        from_p = asg[src] == p
        remote = np.unique(dst[from_p & (asg[dst] != p)])
        owner = asg[remote]
        # reindex: local nodes [0, n_local), halo nodes [n_local, ...)
        old2new = -np.ones(graph.num_nodes, dtype=np.int64)
        old2new[local] = np.arange(n_local)
        old2new[remote] = n_local + np.arange(remote.size)
        keep = from_p & (old2new[dst] >= 0)
        ext = CSRGraph.from_edges(n_local + remote.size,
                                  old2new[src[keep]], old2new[dst[keep]],
                                  symmetrize=True, dedup=True)
        halo_nodes.append(remote.astype(np.int64))
        halo_owner.append(owner.astype(np.int32))
        ext_graphs.append(ext)
        ext_num_local.append(int(n_local))
    return HaloPlan(halo_nodes=halo_nodes, halo_owner=halo_owner,
                    ext_graphs=ext_graphs, ext_num_local=ext_num_local)


# --------------------------------------------------------------------------
# Inference-time plans — L-hop closures for exact embedding serving
# --------------------------------------------------------------------------
def _expand_hops(graph: CSRGraph, seed_nodes: np.ndarray,
                 num_hops: int) -> np.ndarray:
    """All nodes within ``num_hops`` of ``seed_nodes`` (seeds included)."""
    member = np.zeros(graph.num_nodes, bool)
    member[seed_nodes] = True
    frontier = np.asarray(seed_nodes, np.int64)
    for _ in range(num_hops):
        if frontier.size == 0:
            break
        starts, deg = neighbor_spans(graph, frontier)
        nbrs = gather_spans(graph, starts, deg)
        new = np.unique(nbrs[~member[nbrs]])
        member[new] = True
        frontier = new
    return np.flatnonzero(member)


def build_inference_plan(graph: CSRGraph, partition: Partition,
                         num_hops: int = 1) -> HaloPlan:
    """L-hop halo closure for EXACT partitioned inference.

    For each machine the halo is every node within ``num_hops`` of the local
    set and the extended graph is the *induced* subgraph on
    ``local ∪ halo`` (local rows first, halo rows after, halo sorted by
    original id).  Every node at distance ≤ num_hops−1 of the local set then
    carries its complete true neighborhood, so a ``num_hops``-layer
    message-passing forward over the extended view equals the full-graph
    forward on all local rows — the property the serving equivalence tests
    assert.  The returned plan feeds :func:`build_halo_program` unchanged,
    so serve-time cut-node features move through the same lowering the
    training engine executes (just once per wave instead of once per step).

    Unlike the training-time :func:`build_halo_plan` (1-hop, halo-halo edges
    dropped — Eq. 5's extended graph), the induced closure keeps edges among
    halo nodes: those are exactly the paths an L-hop query walks out of its
    partition.
    """
    if num_hops < 1:
        raise ValueError("num_hops must be ≥ 1")
    asg = partition.assignment
    halo_nodes, halo_owner, ext_graphs, ext_num_local = [], [], [], []
    for p in range(partition.num_parts):
        local = partition.part_nodes[p]
        closure = _expand_hops(graph, local, num_hops)
        halo = np.setdiff1d(closure, local, assume_unique=True)
        ext, _ = subgraph_csr(graph, np.concatenate([local, halo]))
        halo_nodes.append(halo.astype(np.int64))
        halo_owner.append(asg[halo].astype(np.int32))
        ext_graphs.append(ext)
        ext_num_local.append(int(local.size))
    return HaloPlan(halo_nodes=halo_nodes, halo_owner=halo_owner,
                    ext_graphs=ext_graphs, ext_num_local=ext_num_local)


def cut_crossing_mask(graph: CSRGraph, assignment: np.ndarray,
                      num_hops: int) -> np.ndarray:
    """Boolean mask: node's ``num_hops`` neighborhood crosses a cut.

    ``mask[v]`` is True iff some node within ``num_hops`` of v lives in a
    different partition — equivalently v is within ``num_hops − 1`` hops of
    a same-partition endpoint of a cut edge.  These are the serving queries
    that exercise the halo path; interior queries are partition-local.
    """
    if num_hops < 1:
        raise ValueError("num_hops must be ≥ 1")
    src, dst = graph.to_edges()
    cut = assignment[src] != assignment[dst]
    crossing = np.zeros(graph.num_nodes, bool)
    for p in np.unique(assignment[src[cut]]) if cut.any() else []:
        seeds = np.unique(src[cut & (assignment[src] == p)])
        reach = _expand_hops(graph, seeds, num_hops - 1)
        crossing[reach[assignment[reach] == p]] = True
    return crossing


# --------------------------------------------------------------------------
# HaloProgram — the exchange as padded, rectangular device index tables
# --------------------------------------------------------------------------
@dataclasses.dataclass
class HaloProgram:
    """The halo exchange lowered to fixed-shape send/recv index tables.

    The exchange is owner-bucketed: machine q contributes each locally-owned
    node that ANY peer needs exactly once (``send_idx[q]``, padded to the
    mesh-wide ``max_send``), an all-gather over the machine axis produces the
    flat ``(P · max_send, d)`` buffer, and each machine p gathers its halo
    rows out of it (``recv_idx[p]``, flat ``owner · max_send + slot``
    indices) and scatters them into its extended feature buffer at
    ``dest_idx[p]`` (rows ``[num_local[p], num_local[p] + H_p)``; padded
    slots point one past the buffer and are dropped).  Every table is padded
    to the mesh-wide max so the program is rectangular — one static shape
    for all machines, all steps.

    Fields (all numpy, P = num_machines):
      send_idx   (P, max_send) int32 — sender-local feature rows (pad 0)
      send_counts (P,) int32         — real send slots per machine
      recv_idx   (P, max_halo) int32 — flat all-gather buffer indices (pad 0)
      dest_idx   (P, max_halo) int32 — ext-buffer rows (pad = n_ext_pad ⇒
                                       the scatter's sink row, sliced off
                                       by ``halo_fill``)
      recv_valid (P, max_halo) f32   — 1.0 for real halo slots
      halo_counts (P,) int32         — real halo rows per machine (H_p)
      num_local  (P,) int32          — local rows per machine
    """

    plan: HaloPlan
    num_machines: int
    max_send: int
    max_halo: int
    n_ext_pad: int
    send_idx: np.ndarray
    send_counts: np.ndarray
    recv_idx: np.ndarray
    dest_idx: np.ndarray
    recv_valid: np.ndarray
    halo_counts: np.ndarray
    num_local: np.ndarray

    # ------------------------------------------------------------- accounting
    def halo_bytes(self, feature_dim: int, dtype=np.float32,
                   compression: str = "none") -> int:
        """Ideal (unpadded, per-receiver) bytes per exchange — see
        :meth:`HaloPlan.halo_bytes`."""
        return self.plan.halo_bytes(feature_dim, dtype=dtype,
                                    compression=compression)

    def exchange_bytes(self, feature_dim: int, dtype=np.float32,
                       compression: str = "none") -> int:
        """Network bytes per EXECUTED exchange, from the collective's operand
        shapes: each of the P devices all-gathers the other P-1 devices'
        padded ``(max_send, d)`` send buffers.  With ``compression`` the
        buffers on the wire are the codec's payload rows
        (:func:`repro_torch.comm.compress.wire_row_bytes` — int8 values plus one
        f32 scale per row), matching what the engine actually all-gathers."""
        from repro_torch.comm.compress import wire_row_bytes
        P = self.num_machines
        return int(P * (P - 1) * self.max_send
                   * wire_row_bytes(feature_dim, dtype, compression))

    def gathered_bytes_per_device(self, feature_dim: int,
                                  dtype=np.float32,
                                  compression: str = "none") -> int:
        """Per-device all-gather RESULT bytes — the ``(P, max_send, d)``
        output shape (plus the scales all-gather for int8), i.e. what a
        collective-bytes scan attributes to the exchange ops."""
        from repro_torch.comm.compress import wire_row_bytes
        return int(self.num_machines * self.max_send
                   * wire_row_bytes(feature_dim, dtype, compression))


def build_halo_program(graph: CSRGraph, partition: Partition,
                       plan: Optional[HaloPlan] = None,
                       n_ext_pad: Optional[int] = None) -> HaloProgram:
    """Lower a :class:`HaloPlan` into a rectangular :class:`HaloProgram`.

    ``n_ext_pad`` is the padded extended-buffer row count the engine will
    run with (defaults to the mesh-wide max ``num_local + halo`` size); the
    scatter's padded destination rows point at ``n_ext_pad`` exactly so they
    fall out of bounds and are dropped.
    """
    if plan is None:
        plan = build_halo_plan(graph, partition)
    P = partition.num_parts
    # owner-bucketed send lists: machine q sends each owned node needed by
    # ANY peer exactly once (sorted, so receivers can searchsorted into it)
    send_lists: List[np.ndarray] = []
    for q in range(P):
        needed = [plan.halo_nodes[p][plan.halo_owner[p] == q]
                  for p in range(P) if p != q]
        needed = (np.unique(np.concatenate(needed)) if needed
                  else np.zeros(0, np.int64))
        send_lists.append(needed.astype(np.int64))

    max_send = max(max((s.size for s in send_lists), default=0), 1)
    max_halo = max(max((h.size for h in plan.halo_nodes), default=0), 1)
    ext_sizes = [plan.ext_num_local[p] + plan.halo_nodes[p].size
                 for p in range(P)]
    if n_ext_pad is None:
        n_ext_pad = max(ext_sizes)
    if n_ext_pad < max(ext_sizes):
        raise ValueError(f"n_ext_pad {n_ext_pad} < largest extended "
                         f"buffer {max(ext_sizes)}")

    send_idx = np.zeros((P, max_send), np.int32)
    send_counts = np.zeros(P, np.int32)
    recv_idx = np.zeros((P, max_halo), np.int32)
    dest_idx = np.full((P, max_halo), n_ext_pad, np.int32)
    recv_valid = np.zeros((P, max_halo), np.float32)
    halo_counts = np.zeros(P, np.int32)
    num_local = np.asarray(plan.ext_num_local, np.int32)

    for q in range(P):
        s = send_lists[q]
        send_counts[q] = s.size
        # sender-local feature row of each sent node
        send_idx[q, : s.size] = partition.old2new[q][s]
    for p in range(P):
        h, owner = plan.halo_nodes[p], plan.halo_owner[p]
        halo_counts[p] = h.size
        slots = np.zeros(h.size, np.int64)
        for q in np.unique(owner):
            sel = owner == q
            slots[sel] = np.searchsorted(send_lists[q], h[sel])
        recv_idx[p, : h.size] = owner.astype(np.int64) * max_send + slots
        dest_idx[p, : h.size] = num_local[p] + np.arange(h.size)
        recv_valid[p, : h.size] = 1.0

    return HaloProgram(plan=plan, num_machines=P, max_send=max_send,
                       max_halo=max_halo, n_ext_pad=int(n_ext_pad),
                       send_idx=send_idx, send_counts=send_counts,
                       recv_idx=recv_idx, dest_idx=dest_idx,
                       recv_valid=recv_valid, halo_counts=halo_counts,
                       num_local=num_local)


def halo_exchange_reference(program: HaloProgram,
                            feats: np.ndarray) -> np.ndarray:
    """Numpy oracle of one full exchange on stacked local features.

    ``feats`` is the engine's ``(P, n_ext_pad, d)`` buffer with only local
    rows filled; returns a copy with every machine's halo rows
    ``[num_local[p], num_local[p] + H_p)`` filled from the owners' local
    rows — exactly what the device exchange produces.
    """
    P, _, d = feats.shape
    send = np.stack([feats[q][program.send_idx[q]] for q in range(P)])
    flat = send.reshape(P * program.max_send, d)
    out = feats.copy()
    for p in range(P):
        hp = int(program.halo_counts[p])
        out[p, program.dest_idx[p, :hp]] = flat[program.recv_idx[p, :hp]]
    return out
