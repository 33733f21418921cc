"""Reuse-distance / locality characterization (paper §2.2, Table 1).

Temporal locality is characterized by the *reuse distance* of each access —
the number of other distinct vectors touched since the last access to the
same vector.  The CDF of reuse distances proxies the hit probability of a
cache holding x vectors: ``CDF(x) ≈ hit rate``.  These tools generate the
paper's L0/L1/L2 locality classes and feed both the characterization
benchmark and the DAE cost model.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def reuse_distances(trace: np.ndarray) -> np.ndarray:
    """Exact reuse distances (−1 for first accesses) via an LRU stack
    maintained with an order-statistics-free O(N·U) fallback or an O(N log N)
    Fenwick tree over last-access times."""
    trace = np.asarray(trace)
    n = len(trace)
    last_seen: dict = {}
    # Fenwick tree over positions: 1 if that position is the *latest* access
    # of its vector, else 0.  Reuse distance = # of set bits strictly between
    # last_seen[v] and now.
    tree = np.zeros(n + 1, np.int64)

    def add(i, v):
        i += 1
        while i <= n:
            tree[i] += v
            i += i & (-i)

    def prefix(i):
        i += 1
        s = 0
        while i > 0:
            s += tree[i]
            i -= i & (-i)
        return s

    out = np.empty(n, np.int64)
    for t, v in enumerate(trace):
        if v in last_seen:
            lp = last_seen[v]
            out[t] = prefix(t - 1) - prefix(lp)
            add(lp, -1)
        else:
            out[t] = -1
        add(t, 1)
        last_seen[v] = t
    return out


def reuse_cdf(trace: np.ndarray, xs: np.ndarray = None):
    """(xs, CDF(xs)) — fraction of accesses with reuse distance ≤ x.

    First accesses count as misses at every cache size (distance ∞)."""
    d = reuse_distances(trace)
    n = len(d)
    if xs is None:
        xs = np.unique(np.concatenate(
            [[1, 2, 4], np.logspace(1, 7, 25).astype(np.int64)]))
    reused = d[d >= 0]
    cdf = np.array([(reused <= x).sum() / n for x in xs])
    return xs, cdf


def hit_rate(trace: np.ndarray, cache_vectors: int) -> float:
    d = reuse_distances(trace)
    return float((d[d >= 0] <= cache_vectors).sum() / len(d))


def row_reuse_scores(trace: np.ndarray, num_rows: int) -> np.ndarray:
    """Per-row replication-benefit score: the number of accesses to each row
    with a *finite* reuse distance (i.e. its re-accesses).

    This is exactly the traffic a replicated copy of the row would absorb —
    a row touched once contributes nothing (its single access pays the
    exchange either way), while the Zipf head re-accessed thousands of times
    is where a hot slab removes exchange volume.  First accesses (distance
    -1 in :func:`reuse_distances`) are excluded by construction."""
    trace = np.asarray(trace, np.int64)
    d = reuse_distances(trace)
    scores = np.zeros(num_rows, np.int64)
    reused = trace[d >= 0]
    if len(reused):
        np.add.at(scores, reused, 1)
    return scores


def classify_hot(trace: np.ndarray, num_rows: int, max_hot: int) -> np.ndarray:
    """The Zipf head of one vocab: up to ``max_hot`` row ids worth
    replicating, ranked by :func:`row_reuse_scores` (ties broken by row id
    for determinism), returned sorted ascending.  Rows with zero reuse are
    never classified hot — an all-distinct trace yields an empty head."""
    if max_hot <= 0 or len(trace) == 0:
        return np.zeros(0, np.int64)
    scores = row_reuse_scores(trace, num_rows)
    candidates = np.flatnonzero(scores > 0)
    if len(candidates) == 0:
        return np.zeros(0, np.int64)
    order = np.lexsort((candidates, -scores[candidates]))
    return np.sort(candidates[order[:int(max_hot)]])


@dataclasses.dataclass(frozen=True)
class AdaptiveHotConfig:
    """Knobs for the executor's sliding-window hot-slab re-classifier.

    Frozen (hashable) so it can participate in executor cache keys.

    * ``window_steps`` — span of the sliding window, in executor steps.
    * ``num_windows`` — ring granularity: the window is a ring of this many
      count sketches, each covering ``window_steps / num_windows`` steps;
      rotating drops the oldest stripe so counts age out instead of
      accumulating for the process lifetime.
    * ``drift_threshold`` — swap trigger: re-classify when the windowed hot
      hit-rate falls below ``drift_threshold ×`` the reference hit-rate
      captured over the first full window after the last (re)classification.
    * ``min_swap_interval`` — steps that must elapse between swaps, bounding
      respecialization churn under oscillating traffic.
    * ``spill_fraction`` — cap on the fraction of an overloaded source
      shard's hot lookups that may spill to the least-loaded peer.
    * ``spill_overload`` — a source shard's lattice diagonal counts as
      overloaded when it exceeds this multiple of the mean diagonal load.
    * ``refine_passes`` — settling re-ranks after a drift-triggered swap.
      The reactive swap classifies on a window still partially filled with
      pre-drift counts; the swap flushes the window, and each refine pass
      re-ranks once the window has refilled with purely post-swap traffic,
      evicting rows the contaminated ranking kept.
    """
    window_steps: int = 64
    num_windows: int = 4
    drift_threshold: float = 0.6
    min_swap_interval: int = 32
    spill_fraction: float = 0.25
    spill_overload: float = 1.5
    refine_passes: int = 1

    def __post_init__(self):
        if self.window_steps < self.num_windows or self.num_windows < 1:
            raise ValueError("window_steps must be >= num_windows >= 1")
        if not (0.0 < self.drift_threshold <= 1.0):
            raise ValueError("drift_threshold must be in (0, 1]")
        if not (0.0 <= self.spill_fraction <= 1.0):
            raise ValueError("spill_fraction must be in [0, 1]")
        if self.refine_passes < 0:
            raise ValueError("refine_passes must be >= 0")


class WindowedCounts:
    """Per-row access counts over a sliding window of the last W steps.

    A ring of ``num_windows`` count stripes; each stripe accumulates
    ``window_steps // num_windows`` steps, then the ring advances and the
    oldest stripe is cleared.  ``totals()`` sums the ring — a bounded-age
    sketch of the recent head, unlike a lifetime-cumulative counter that
    drowns drift under history."""

    def __init__(self, num_rows: int, window_steps: int = 64,
                 num_windows: int = 4):
        if window_steps < num_windows or num_windows < 1:
            raise ValueError("window_steps must be >= num_windows >= 1")
        self.num_rows = int(num_rows)
        self.window_steps = int(window_steps)
        self.num_windows = int(num_windows)
        self.stride = max(1, self.window_steps // self.num_windows)
        self._ring = np.zeros((self.num_windows, self.num_rows), np.int64)
        self._slot = 0
        self._steps = 0          # lifetime steps observed
        self._wrapped = False    # True once every stripe has been filled

    @property
    def full(self) -> bool:
        """True once the ring spans a complete window."""
        return self._wrapped

    @property
    def steps(self) -> int:
        return self._steps

    def add(self, rows: np.ndarray) -> None:
        """Record one step's accessed row ids (any shape, any multiplicity).
        Out-of-range ids are ignored (hardening repairs run downstream)."""
        rows = np.asarray(rows, np.int64).ravel()
        if len(rows):
            rows = rows[(rows >= 0) & (rows < self.num_rows)]
            np.add.at(self._ring[self._slot], rows, 1)
        self._steps += 1
        if self._steps % self.stride == 0:
            self._slot = (self._slot + 1) % self.num_windows
            if self._slot == 0:
                self._wrapped = True
            self._ring[self._slot] = 0

    def totals(self) -> np.ndarray:
        """Summed per-row counts across the ring (the windowed sketch)."""
        return self._ring.sum(axis=0)

    def reset(self) -> None:
        self._ring[:] = 0
        self._slot = 0
        self._steps = 0
        self._wrapped = False


def classify_hot_from_counts(counts: np.ndarray, max_hot: int,
                             prev_hot: np.ndarray = None) -> np.ndarray:
    """Re-rank the hot set from windowed per-row counts.

    Same contract as :func:`classify_hot` — top ``max_hot`` rows by count,
    ties broken by row id, returned sorted ascending — but from live counts
    instead of a calibration trace.  Because a swapped slab must keep every
    slot's table shape constant (the lattice/executables are specialized on
    sizes, not membership), the result is padded with ``prev_hot`` ids (in
    their ranked order of recency-of-use, i.e. count-desc) so the returned
    set has *exactly* ``len(prev_hot)`` rows whenever ``prev_hot`` is
    given."""
    counts = np.asarray(counts, np.int64)
    if max_hot <= 0:
        return np.zeros(0, np.int64)
    candidates = np.flatnonzero(counts > 0)
    order = np.lexsort((candidates, -counts[candidates]))
    hot = candidates[order[:int(max_hot)]]
    if prev_hot is not None:
        prev_hot = np.asarray(prev_hot, np.int64)
        want = len(prev_hot)
        if len(hot) < want:
            # keep previously-hot rows (highest windowed count first) to
            # hold the set size — shape stability beats eviction here
            fill = prev_hot[~np.isin(prev_hot, hot)]
            fill = fill[np.argsort(-counts[fill], kind="stable")]
            hot = np.concatenate([hot, fill[:want - len(hot)]])
        else:
            hot = hot[:want]
    return np.sort(hot)


def make_trace(num_vectors: int, num_accesses: int, locality: str = "L1",
               seed: int = 0) -> np.ndarray:
    """Synthetic DLRM-style traces with low/medium/high locality
    (paper §8.1, following the Meta synthetic-input methodology [18])."""
    rng = np.random.default_rng(seed)
    alpha = {"L0": 0.0, "L1": 0.8, "L2": 1.4}[locality]
    if alpha == 0.0:
        return rng.integers(0, num_vectors, num_accesses).astype(np.int64)
    ranks = np.arange(1, num_vectors + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    perm = rng.permutation(num_vectors)
    return perm[rng.choice(num_vectors, size=num_accesses, p=p)]
