"""The exponentially-increasing local-epoch schedule of Section 3.1.

Round r runs ``K·ρ^r`` local steps (ρ > 1), so a budget of T total local
steps costs only ``R = O(log_ρ(T/K))`` communication rounds instead of the
fully-synchronous O(T).  ρ = 1 recovers PSGD-PA's fixed schedule.

:class:`KBucketing` is the compile-cost companion of that schedule: the
engine's round program retraces once per distinct K (the scan length is a
static shape), so the exponential schedule would otherwise compile every
round.  Bucketing rounds each K up to a geometric grid of lengths and runs
the padded tail as *masked* steps (:func:`repro_torch.optim.optimizers.
masked_update`), bounding compilation at O(log_growth K_max) programs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Tuple


def local_epoch_schedule(base_k: int, rho: float, num_rounds: int) -> List[int]:
    """[K·ρ¹, K·ρ², …, K·ρ^R], rounded to ≥1 integer steps."""
    if base_k < 1:
        raise ValueError("base_k must be ≥ 1")
    if rho < 1.0:
        raise ValueError("ρ must be ≥ 1 (paper uses ρ > 1; ρ=1 is PSGD-PA)")
    return [max(1, int(round(base_k * rho ** r))) for r in range(1, num_rounds + 1)]


@dataclasses.dataclass(frozen=True)
class KBucketing:
    """Round scheduled K values up to a grid of scan lengths.

    Default grid: geometric — bucket lengths are ``min_len · growth^i``; a
    round scheduled for K real steps runs in the smallest bucket ≥ K, with
    the tail executed as masked no-op steps.  ``run_schedule`` pads the
    round inputs and threads the per-step validity flags, so a full
    exponential-ρ schedule compiles ``O(log_growth(K_max / min_len))``
    distinct round programs instead of one per round.  Wasted (masked)
    compute per round is bounded by a factor ``growth``; growth=2 keeps it
    < 2× while needing at most ``⌈log2 K_max⌉`` programs.

    Schedule-aware grid: when the schedule is known up front (it always is
    for LLCG's ``K·ρ^r``), :meth:`fit` replaces the geometric grid with an
    explicit ``lengths`` tuple whose bucket tops are drawn from the
    *realized* K values — minimizing total masked steps subject to at most
    as many buckets as the geometric grid would compile, so masked-step
    waste drops with NO extra retraces (``fitted.masked_steps(schedule) ≤
    geometric.masked_steps(schedule)``, tested property).
    """

    min_len: int = 1
    growth: int = 2
    lengths: Optional[Tuple[int, ...]] = None  # explicit ascending grid

    def __post_init__(self):
        if self.min_len < 1:
            raise ValueError("min_len must be ≥ 1")
        if self.growth < 2:
            raise ValueError("growth must be ≥ 2")
        if self.lengths is not None:
            if not self.lengths or any(l < 1 for l in self.lengths) or \
                    list(self.lengths) != sorted(set(self.lengths)):
                raise ValueError("lengths must be distinct ascending ≥ 1")

    def pad_length(self, k: int) -> int:
        """Smallest bucket length ≥ k."""
        if k < 1:
            raise ValueError("k must be ≥ 1")
        if self.lengths is not None:
            for b in self.lengths:
                if b >= k:
                    return b
            raise ValueError(f"K={k} exceeds the fitted grid "
                             f"(max {self.lengths[-1]}); refit with the "
                             "full schedule")
        b = self.min_len
        while b < k:
            b *= self.growth
        return b

    def bucket_lengths(self, schedule: Iterable[int]) -> List[int]:
        """The distinct bucket lengths a schedule compiles to, sorted."""
        return sorted({self.pad_length(k) for k in schedule})

    def masked_steps(self, schedule: Iterable[int]) -> int:
        """Total padded (masked no-op) steps over the whole schedule."""
        return sum(self.pad_length(k) - k for k in schedule)

    @classmethod
    def fit(cls, schedule: Iterable[int], max_buckets: Optional[int] = None,
            min_len: int = 1, growth: int = 2) -> "KBucketing":
        """Fit an explicit grid to a known schedule.

        Chooses ≤ ``max_buckets`` bucket tops (default: however many the
        geometric ``(min_len, growth)`` grid would compile for this
        schedule) from the schedule's distinct K values so total masked
        steps are minimal; lowering any grid point to the largest realized
        K beneath it never hurts, so restricting tops to realized values
        loses nothing.  Exact dynamic program, O(n²·buckets) on n distinct
        values (span costs are O(1) via prefix sums).
        """
        schedule = list(schedule)
        if not schedule:
            raise ValueError("cannot fit an empty schedule")
        geometric = cls(min_len=min_len, growth=growth)
        if max_buckets is None:
            max_buckets = len(geometric.bucket_lengths(schedule))
        if max_buckets < 1:
            raise ValueError("max_buckets must be ≥ 1")
        ks = sorted(set(schedule))
        weights = [schedule.count(k) for k in ks]
        n = len(ks)
        m = min(max_buckets, n)
        # prefix sums of Σw and Σw·k make each span cost O(1)
        cw = [0] * (n + 1)
        cwk = [0] * (n + 1)
        for i in range(n):
            cw[i + 1] = cw[i] + weights[i]
            cwk[i + 1] = cwk[i] + weights[i] * ks[i]

        def span_cost(a: int, b: int) -> int:
            """Masked steps of rounds with K in ks[a..b] padded to ks[b]."""
            return ks[b] * (cw[b + 1] - cw[a]) - (cwk[b + 1] - cwk[a])

        INF = float("inf")
        # best[c][j]: min waste covering ks[0..j] with c buckets, ks[j] a top
        best = [[INF] * n for _ in range(m + 1)]
        back = [[-1] * n for _ in range(m + 1)]
        for j in range(n):
            best[1][j] = span_cost(0, j)
        for c in range(2, m + 1):
            for j in range(c - 1, n):
                for i in range(c - 2, j):
                    cand = best[c - 1][i] + span_cost(i + 1, j)
                    if cand < best[c][j]:
                        best[c][j], back[c][j] = cand, i
        c_star = min(range(1, m + 1), key=lambda c: best[c][n - 1])
        tops, j = [], n - 1
        for c in range(c_star, 0, -1):
            tops.append(ks[j])
            j = back[c][j]
        return cls(min_len=min_len, growth=growth,
                   lengths=tuple(sorted(tops)))


def num_rounds_for_budget(base_k: int, rho: float, total_steps: int) -> int:
    """Smallest R with Σ_{r≤R} K·ρ^r ≥ T  (≈ log_ρ(T/K))."""
    if rho == 1.0:
        return max(1, math.ceil(total_steps / base_k))
    r, acc = 0, 0
    while acc < total_steps:
        r += 1
        acc += max(1, int(round(base_k * rho ** r)))
        if r > 10_000:
            raise RuntimeError("schedule does not reach budget — check K/ρ")
    return r


def theorem2_k_constraint(base_k: int, rho: float, num_rounds: int,
                          lipschitz: float, num_machines: int,
                          total_steps: int) -> bool:
    """Check Σ K²ρ^{2r} ≤ R·T^{1/2} / (32 L² P^{3/2}) — Theorem 2's condition."""
    lhs = sum((base_k * rho ** r) ** 2 for r in range(1, num_rounds + 1))
    rhs = num_rounds * math.sqrt(total_steps) / (32 * lipschitz ** 2 * num_machines ** 1.5)
    return lhs <= rhs
