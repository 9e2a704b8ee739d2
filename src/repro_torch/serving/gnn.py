"""GNN embedding/prediction serving over a partitioned graph — the port of
the JAX package's ``serving/gnn.py``.

The LLCG end product is a globally corrected GNN whose value is realized at
inference time: answering node-classification / embedding queries while
the graph STAYS partitioned across machines.  This module provides the GNN
backends for both scheduler shapes of :mod:`repro_torch.serving.core` —
:class:`GNNBackend` behind the wave scheduler and :class:`GNNSlotBackend`
behind the slot scheduler — closing the train→serve loop for params a
:class:`~repro_torch.core.plan.TrainPlan` exported through
``checkpoint_dir`` (restored by :mod:`repro_torch.checkpoint.store`).

Execution model, per wave of queries, on ``device`` (``"cuda"`` unless the
caller passes another):

* Every machine holds only its local feature rows.  At build time the
  L-hop inference halo (``L = model.num_message_hops()``) is lowered by
  :func:`~repro_torch.graph.halo.build_inference_plan` +
  :func:`~repro_torch.graph.halo.build_halo_program` — the padded exchange
  the training engine's halo mode runs — run here once per wave
  (:func:`_halo_exchange`), with the training engine's halo codec on the
  send buffer (``halo_compression="int8"``: one quantize and one dequantize
  kernel launch per wave on the card).
* Neighbor tables come from the host sampler
  (:func:`~repro_torch.graph.sampling.sample_serving_tables`, numpy, so
  they are bit-equal to the JAX package's), or with
  ``sampler_placement="device"`` from the device sampler
  (:func:`~repro_torch.graph.sampling.sample_serving_tables_device` over
  one device-resident stack of the extended graphs, keyed by
  :func:`repro_torch.serving.core.wave_key`: the JAX package's
  ``jax.random`` tables, bit for bit).  Full width (``fanout=None``)
  reproduces the single-machine full-graph forward; narrower widths
  subsample.  Widths round up to a geometric grid, so each width bucket is
  one input signature (``num_retraces`` counts distinct signatures, as
  the JAX package counts jit traces).
* One parameter set serves all P machines: the forward runs the P stacked
  graphs at once with the params expanded (no copy) over the machine axis;
  a fused GAT model's aggregation is one edge-softmax launch per layer
  over all P graphs.  Full-width buckets may run edge-centric
  (``agg_layout="csr"`` / ``"auto"``) over stacked ``(P, E_max)`` edge
  operands whose pad edges are dropped.
* Optionally a serve-time analogue of the Global Server Correction runs
  first: ``correction_steps`` optimizer steps on labeled train nodes of
  the queried extended subgraphs, each on the mean over machines of the
  machines' masked-mean losses.  The refined params and the optimizer
  state are wave-local; the stored params are never mutated.

Sampling is deterministic per wave content (:func:`repro_torch.serving.
core.wave_rng` / ``wave_key`` over the request uids).  Batch-statistics
architectures (``B`` ops) are refused: their statistics depend on the
partition's padded row set.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.manager import TraceCounter, trace_signature
from repro_torch.checkpoint.store import load_params
from repro_torch.comm.compress import (check_compression, compress_features,
                                       decompress_features)
from repro_torch.core.machine import halo_fill, make_loss_fn
from repro_torch.core.schedules import KBucketing
from repro_torch.graph.datasets import SyntheticDataset
from repro_torch.graph.halo import (build_halo_program, build_inference_plan,
                                    cut_crossing_mask)
from repro_torch.graph.partition import Partition, partition_graph
from repro_torch.graph.sampling import (build_device_csr, sample_minibatch,
                                        sample_serving_tables,
                                        sample_serving_tables_device)
from repro_torch.models.gnn.agg import (AggOperands, choose_layout,
                                        stacked_edge_operands)
from repro_torch.models.gnn.model import GNNModel
from repro_torch.optim.optimizers import adam, apply_updates, sgd
from repro_torch.serving.core import (ServingBackend, SlotBackend,
                                      SlotScheduler, WaveScheduler, wave_key,
                                      wave_rng)
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten


def _halo_exchange(feats: torch.Tensor, send_idx: torch.Tensor,
                   recv_idx: torch.Tensor, dest_idx: torch.Tensor,
                   recv_valid: torch.Tensor,
                   compression: str = "none") -> torch.Tensor:
    """One halo fill of the ``(P, n_ext_pad, d)`` feature buffer: the
    machines' send rows gathered into one flat buffer (what the all-gather
    hands every machine), passed through the halo codec, and spliced into
    every machine's halo rows.  Shared by the wave backend (every wave) and
    the slot backend (once: inference features are static)."""
    P, _, d = feats.shape
    rows = torch.arange(P, device=feats.device)[:, None]
    flat = feats[rows, send_idx.long()].reshape(-1, d)
    if compression != "none":
        payload, scales = compress_features(flat, compression)
        flat = decompress_features(payload, scales, compression)
    return halo_fill(feats, flat, recv_idx, dest_idx, recv_valid)


def _expand(params: Dict, P: int) -> Dict:
    """One parameter set as P stacked ones: a view, no copy; gradients
    through it sum over the machines."""
    return tree_map(lambda x: x[None].expand(P, *x.shape), params)


@dataclasses.dataclass
class GNNRequest:
    """A node-classification / embedding query.

    ``nodes`` are original graph ids (any machine, any count).  ``fanout``
    optionally narrows this query's neighbor tables below the engine
    default, rounded up to the width grid.  ``return_embeddings`` attaches
    the final-layer logit rows beside the argmax predictions.
    """

    uid: int
    nodes: Sequence[int]
    fanout: Optional[int] = None
    return_embeddings: bool = False


@dataclasses.dataclass
class GNNServeResult:
    uid: int
    nodes: List[int]
    predictions: List[int]
    embeddings: Optional[np.ndarray]
    latency_s: float
    wave: int
    halo: bool          # some target's L-hop field crosses a partition cut
    corrected: bool     # served through the online correction pass


class GNNBackend(ServingBackend):
    """Partitioned-graph GNN execution behind the wave scheduler."""

    def __init__(self, model: GNNModel, params, data: SyntheticDataset,
                 partition: Partition, *, fanout: Optional[int] = None,
                 num_hops: Optional[int] = None, correction_steps: int = 0,
                 correction_batch: int = 32, server_lr: float = 1e-2,
                 server_optimizer: str = "sgd", width_min: int = 8,
                 width_growth: int = 2, seed: int = 0,
                 sampler_placement: str = "host",
                 agg_layout: Optional[str] = None,
                 halo_compression: str = "none", device="cuda"):
        check_compression(halo_compression, halo=True)
        if sampler_placement not in ("host", "device"):
            raise ValueError(f"unknown sampler_placement "
                             f"{sampler_placement!r}; choose 'host' or "
                             "'device'")
        if "B" in model.arch:
            raise ValueError(
                f"arch {model.arch!r} uses batch statistics — partitioned "
                "serving cannot reproduce its training-time node-axis "
                "normalization")
        self.device = torch.device(device)
        self.model, self.data, self.partition = model, data, partition
        self.params = tree_map(
            lambda x: torch.as_tensor(x).to(self.device), params)
        self.seed = seed
        self.num_hops = (num_hops if num_hops is not None
                         else model.num_message_hops())

        # L-hop inference halo, lowered through the training-engine path
        self.plan = build_inference_plan(data.graph, partition,
                                         self.num_hops)
        self.program = build_halo_program(data.graph, partition,
                                          plan=self.plan)
        self.n_ext_pad = self.program.n_ext_pad
        self.crossing = cut_crossing_mask(data.graph, partition.assignment,
                                          self.num_hops)

        P, d = partition.num_parts, data.feature_dim
        feats = np.zeros((P, self.n_ext_pad, d), np.float32)
        labels = np.zeros((P, self.n_ext_pad), np.int32)
        self._train_rows: List[np.ndarray] = []
        for p in range(P):
            local = partition.part_nodes[p]
            feats[p, : local.size] = data.features[local]
            labels[p, : local.size] = data.labels[local]
            tr = partition.old2new[p][
                np.intersect1d(data.train_nodes, local)]
            self._train_rows.append(tr.astype(np.int64))
        self.feats = self._dev(feats)
        self.labels = self._dev(labels)
        # original id → (owner, owner-local row)
        self._loc = np.zeros(data.num_nodes, np.int64)
        for p in range(P):
            self._loc[partition.part_nodes[p]] = np.arange(
                partition.part_nodes[p].size)

        self.full_fanout = max(max(g.max_degree()
                                   for g in self.plan.ext_graphs), 1)
        self.default_fanout = (self.full_fanout if fanout is None
                               else max(min(int(fanout), self.full_fanout),
                                        1))
        self.width_grid = KBucketing(
            min_len=min(int(width_min), self.full_fanout),
            growth=width_growth)

        # full-width buckets are the deterministic full-neighbor forward,
        # so they may run edge-centric from one prebuilt stacked edge
        # inventory; narrower buckets are sampled and stay padded
        resolved = model.agg_layout if agg_layout is None else agg_layout
        if resolved == "bcsr_kernel":
            raise ValueError(
                "agg_layout='bcsr_kernel' is a train-side layout — the "
                "serving forward vmaps across machines and routes "
                "edge-centric buckets through 'csr'; use 'csr' or 'auto'")
        if resolved not in ("padded", "csr", "auto"):
            raise ValueError(f"unknown serving agg_layout {resolved!r}; "
                             "choose 'padded', 'csr' or 'auto'")
        self.agg_layout = resolved
        self._agg_full = None
        self._ext_edges_total = sum(g.num_edges
                                    for g in self.plan.ext_graphs)
        if resolved != "padded":
            self._agg_full = AggOperands("csr", edges=stacked_edge_operands(
                list(self.plan.ext_graphs), self.n_ext_pad, self.device))

        self.correction_steps = int(correction_steps)
        self.correction_batch = int(correction_batch)
        opt = {"sgd": sgd, "adam": adam}.get(server_optimizer)
        if opt is None:
            raise ValueError(f"unknown server optimizer "
                             f"{server_optimizer!r}")
        self._server_opt = opt(server_lr)
        self._loss_fn = make_loss_fn(model)

        self._traces = TraceCounter()
        self._widths_compiled: set = set()
        self.halo_compression = halo_compression
        self.exchange_bytes_per_wave = self.program.exchange_bytes(
            d, dtype=np.float32, compression=halo_compression)
        self._bytes_cum = 0.0
        self._nodes_served = 0
        self._halo_idx = tuple(self._dev(a) for a in (
            self.program.send_idx, self.program.recv_idx,
            self.program.dest_idx, self.program.recv_valid))
        self.sampler_placement = sampler_placement
        if sampler_placement == "device":
            # the wave's tables are drawn on the device from one padded
            # stack of the extended graphs, built once
            self._dcsr = build_device_csr(list(self.plan.ext_graphs),
                                          n_pad=self.n_ext_pad,
                                          device=self.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _tables(self, width: int, uids: Sequence[int],
                rng: np.random.Generator):
        """One wave's ``(P, n_ext_pad, width)`` tables and masks on the
        device: drawn there under ``wave_key(seed, uids)``, or on the host
        from ``rng``."""
        if self.sampler_placement == "device":
            return sample_serving_tables_device(
                self._dcsr, wave_key(self.seed, uids), width)
        tables, masks = sample_serving_tables(self.plan.ext_graphs, width,
                                              rng, self.n_ext_pad)
        return self._dev(tables), self._dev(masks)

    @property
    def num_retraces(self) -> int:
        """Distinct serve-input signatures (one per width bucket and
        layout): the programs a compiled serve path would build."""
        return self._traces.count_value

    # ------------------------------------------------------------ execution
    def _agg_for_width(self, width: int) -> Optional[AggOperands]:
        """Prebuilt edge-centric operands for this width bucket, or
        ``None`` for the padded path.  Only the full-width bucket is
        eligible; ``auto`` consults the cost model on the stacked geometry."""
        if self.agg_layout == "padded" or width < self.full_fanout:
            return None
        if self.agg_layout == "csr":
            return self._agg_full
        lay = choose_layout(
            "auto", num_nodes=self.partition.num_parts * self.n_ext_pad,
            num_edges=self._ext_edges_total, width=width,
            full_width=self.full_fanout)
        return self._agg_full if lay == "csr" else None

    def _exchange(self) -> torch.Tensor:
        return _halo_exchange(self.feats, *self._halo_idx,
                              compression=self.halo_compression)

    def _forward(self, params, ext, tables, masks, agg) -> torch.Tensor:
        """(P, n_ext_pad, C) logits of every machine's extended graph."""
        with torch.no_grad():
            return self.model.apply_stacked(_expand(params, ext.shape[0]),
                                            ext, tables, masks, agg=agg)

    def _correct(self, ext, tables, masks, cbatches, cbmasks, agg):
        """The serve-time correction: S server-optimizer steps from the
        stored params on wave-local state; returns the refined params."""
        P = ext.shape[0]
        params = self.params
        state = self._server_opt.init(params)
        for s in range(cbatches.shape[0]):
            leaves = [x.detach().requires_grad_(True)
                      for x in tree_leaves(params)]
            losses = self._loss_fn(
                _expand(tree_unflatten(params, leaves), P), ext, tables,
                masks, cbatches[s], self.labels, cbmasks[s], agg=agg)
            # Σ_p loss_p / P: the mean over machines of each machine's
            # gradient, as the JAX package averages them
            grads = torch.autograd.grad(losses.sum() / P, leaves)
            grads = tree_unflatten(params, list(grads))
            upd, state = self._server_opt.update(grads, state, params)
            params = apply_updates(params, upd)
        return params

    def _serve(self, tables, masks, cbatches, cbmasks, agg) -> torch.Tensor:
        self._traces.count(trace_signature(
            (tables, masks, cbatches, cbmasks),
            static=(None if agg is None else agg.layout,)))
        with torch.no_grad():
            ext = self._exchange()
        params = self.params
        if self.correction_steps > 0:
            params = self._correct(ext, tables, masks, cbatches, cbmasks,
                                   agg)
        return self._forward(params, ext, tables, masks, agg)

    # ------------------------------------------------------------- protocol
    def validate(self, req: GNNRequest) -> None:
        nodes = np.asarray(req.nodes, np.int64)
        if nodes.size == 0:
            raise ValueError(f"request {req.uid} names no nodes")
        if nodes.min() < 0 or nodes.max() >= self.data.num_nodes:
            raise ValueError(f"request {req.uid} names nodes outside "
                             f"[0, {self.data.num_nodes})")
        if req.fanout is not None and req.fanout < 1:
            raise ValueError(f"request {req.uid} fanout must be ≥ 1")

    def _width(self, req: GNNRequest) -> int:
        # per-request fanout only narrows: the engine default is the
        # operator's wave-cost bound, clients cannot widen past it
        eff = (self.default_fanout if req.fanout is None
               else min(int(req.fanout), self.default_fanout))
        return min(self.width_grid.pad_length(eff), self.full_fanout)

    def bucket_key(self, req: GNNRequest) -> int:
        return self._width(req)

    def _result(self, req: GNNRequest, logits: np.ndarray, latency: float,
                wave: int, corrected: bool) -> GNNServeResult:
        nodes = np.asarray(req.nodes, np.int64)
        rows = logits[self.partition.assignment[nodes], self._loc[nodes]]
        self._nodes_served += nodes.size
        return GNNServeResult(
            uid=req.uid, nodes=[int(v) for v in nodes],
            predictions=[int(c) for c in rows.argmax(-1)],
            embeddings=rows.copy() if req.return_embeddings else None,
            latency_s=latency, wave=wave,
            halo=bool(self.crossing[nodes].any()), corrected=corrected)

    def run_wave(self, wave: Sequence[GNNRequest], wave_index: int
                 ) -> List[GNNServeResult]:
        t0 = time.perf_counter()
        width = self._width(wave[0])        # bucketed: all equal
        uids = [r.uid for r in wave]
        rng = wave_rng(self.seed, uids)
        tables, masks = self._tables(width, uids, rng)
        cbatches, cbmasks = self._correction_batches(rng)
        logits = self._serve(tables, masks,
                             self._dev(cbatches), self._dev(cbmasks),
                             self._agg_for_width(width)).cpu().numpy()
        self._widths_compiled.add(width)
        self._bytes_cum += self.exchange_bytes_per_wave
        latency = time.perf_counter() - t0  # one forward: the wave IS
        return [self._result(r, logits, latency, wave_index,  # every
                             self.correction_steps > 0)       # request's
                for r in wave]                                # path

    def _correction_batches(self, rng: np.random.Generator):
        """(S, P, B) labeled local-train batches + masks for the refinement
        pass; machines without train nodes contribute zero-weight rows."""
        S, B = self.correction_steps, self.correction_batch
        P = self.partition.num_parts
        batches = np.zeros((max(S, 1), P, B), np.int32)
        bmasks = np.zeros((max(S, 1), P, B), np.float32)
        if S > 0:
            for s in range(S):
                for p, tr in enumerate(self._train_rows):
                    if tr.size == 0:
                        continue
                    batches[s, p] = sample_minibatch(tr, B, rng)
                    bmasks[s, p] = 1.0
        return batches, bmasks

    def stats(self) -> Dict:
        return {"num_retraces": self.num_retraces,
                "agg_layout": self.agg_layout,
                "sampler_placement": self.sampler_placement,
                "widths_compiled": sorted(self._widths_compiled),
                "num_hops": self.num_hops,
                "full_fanout": self.full_fanout,
                "halo_compression": self.halo_compression,
                "exchange_bytes_per_wave": self.exchange_bytes_per_wave,
                "exchange_bytes_cum": self._bytes_cum,
                "nodes_served": self._nodes_served}


class GNNSlotBackend(GNNBackend, SlotBackend):
    """Continuous GNN serving with incremental re-serving per width bucket.

    A query is one-shot (service = one scheduler step), so the win over the
    wave backend is not redoing wave-scoped work every batch:

    * the halo-exchanged feature rows are computed ONCE (inference features
      are static) and reused by every step;
    * neighbor tables and the full partitioned forward over them are
      computed once per **width bucket** and cached, so an admitted slot
      pays sampling + forward only when its bucket is new, else its step
      is a row gather.

    Determinism is per request: a bucket's tables are drawn from a
    generator seeded by the width alone, so a request's predictions depend
    only on (engine seed, its width bucket) — never on co-resident slots or
    admission order.  The serve-time correction stays wave-only (its
    batches are wave-scoped by construction).
    """

    def __init__(self, model: GNNModel, params, data: SyntheticDataset,
                 partition: Partition, *, num_slots: int = 8, **backend_kw):
        if backend_kw.get("correction_steps", 0):
            raise ValueError(
                "online correction is wave-scoped — serve corrected "
                "predictions through scheduler='wave', or train the "
                "correction in (correction_steps=0 here)")
        if num_slots < 1:
            raise ValueError("num_slots must be ≥ 1")
        super().__init__(model, params, data, partition, **backend_kw)
        self._num_slots = int(num_slots)
        self._slot_entries: Dict[int, Dict] = {}
        self._bucket_logits: Dict[int, np.ndarray] = {}
        self._ext = None                       # halo-filled features, cached
        self._serve_steps = 0
        self._forward_traces = TraceCounter()
        self.exchange_runs = 0

    @property
    def num_slots(self) -> int:
        return self._num_slots

    @property
    def forward_retraces(self) -> int:
        return self._forward_traces.count_value

    def _bucket(self, width: int) -> np.ndarray:
        """Logits for one width bucket, computed on first use and cached."""
        cached = self._bucket_logits.get(width)
        if cached is not None:
            return cached
        if self._ext is None:                  # one-time halo exchange
            with torch.no_grad():
                self._ext = self._exchange()
            self.exchange_runs += 1
            self._bytes_cum += self.exchange_bytes_per_wave
        tables, masks = self._tables(width, [width],
                                     wave_rng(self.seed, [width]))
        agg = self._agg_for_width(width)
        self._forward_traces.count(trace_signature(
            (tables, masks), static=(None if agg is None else agg.layout,)))
        logits = self._forward(self.params, self._ext, tables, masks,
                               agg).cpu().numpy()
        self._widths_compiled.add(width)
        self._bucket_logits[width] = logits
        return logits

    def admit(self, slot: int, req: GNNRequest) -> None:
        """Install the query; only a never-seen width bucket pays sampling
        + forward here."""
        width = self._width(req)
        self._bucket(width)
        self._slot_entries[slot] = {"req": req, "width": width,
                                    "t0": time.perf_counter()}
        return None

    def step(self) -> Dict[int, GNNServeResult]:
        """Serve every occupied slot from its bucket's cached logits."""
        self._serve_steps += 1
        now = time.perf_counter()
        finished = {
            slot: self._result(e["req"], self._bucket_logits[e["width"]],
                               now - e["t0"], self._serve_steps, False)
            for slot, e in sorted(self._slot_entries.items())}
        self._slot_entries.clear()
        return finished

    def stats(self) -> Dict:
        s = super().stats()
        s.update({"num_retraces": self.forward_retraces,
                  "forward_retraces": self.forward_retraces,
                  "exchange_runs": self.exchange_runs,
                  "bucket_widths_cached": sorted(self._bucket_logits),
                  "serve_steps": self._serve_steps})
        return s


class GNNServingEngine:
    """User-facing GNN serving: a GNN backend behind a scheduler, on
    ``device`` (the GPU unless the caller passes another).

    Construct with in-memory params, or restore params a round engine
    exported with :meth:`from_checkpoint` / :meth:`from_plan` — the other
    half of ``TrainPlan.checkpoint_dir``.
    """

    def __init__(self, model: GNNModel, params, data: SyntheticDataset,
                 partition: Optional[Partition] = None,
                 num_machines: int = 4, partition_method: str = "bfs",
                 batch_size: int = 8, seed: int = 0,
                 scheduler: str = "wave", device="cuda", **backend_kw):
        if scheduler not in ("wave", "slot"):
            raise ValueError(f"unknown scheduler {scheduler!r}; choose "
                             "'wave' or 'slot'")
        if partition is None:
            partition = partition_graph(data.graph, num_machines,
                                        method=partition_method, seed=seed)
        self.partition = partition
        if scheduler == "slot":
            self.backend = GNNSlotBackend(model, params, data, partition,
                                          seed=seed, num_slots=batch_size,
                                          device=device, **backend_kw)
            self.scheduler = SlotScheduler(self.backend)
        else:
            self.backend = GNNBackend(model, params, data, partition,
                                      seed=seed, device=device, **backend_kw)
            self.scheduler = WaveScheduler(self.backend,
                                           batch_size=batch_size)
        self.batch_size = batch_size

    @classmethod
    def from_checkpoint(cls, directory: str, model: GNNModel,
                        data: SyntheticDataset, step: Optional[int] = None,
                        device="cuda", **kw) -> "GNNServingEngine":
        """Restore params exported by a round engine (either package's
        ``step_<n>.npz``) onto ``device`` and serve them."""
        params, meta = load_params(directory, model.init_numpy(0), step=step,
                                   device=device)
        engine = cls(model, params, data, device=device, **kw)
        engine.checkpoint_meta = meta
        return engine

    @classmethod
    def from_plan(cls, plan, model: GNNModel, data: SyntheticDataset,
                  step: Optional[int] = None, **kw) -> "GNNServingEngine":
        """Serve the params a :class:`~repro_torch.core.plan.TrainPlan`
        exported: restores the newest (or ``step``-th) round's params from
        ``plan.checkpoint_dir`` and re-derives the serving partition from
        the plan's ``CommSpec`` and seed.  Any keyword overrides the plan's
        value."""
        if plan.checkpoint_dir is None:
            raise ValueError(
                "plan has no checkpoint_dir — set TrainPlan.checkpoint_dir "
                "(or DistConfig.checkpoint_dir) so training exports params "
                "for serving")
        kw.setdefault("num_machines", plan.comm.num_machines)
        kw.setdefault("partition_method", plan.comm.partition_method)
        kw.setdefault("seed", plan.seed)
        kw.setdefault("halo_compression", plan.comm.halo_compression)
        return cls.from_checkpoint(plan.checkpoint_dir, model, data,
                                   step=step, **kw)

    @property
    def params(self):
        return self.backend.params

    def submit(self, req: GNNRequest) -> None:
        self.scheduler.submit(req)

    def run(self) -> List[GNNServeResult]:
        return self.scheduler.run()

    def stats(self) -> Dict:
        return self.scheduler.stats()
