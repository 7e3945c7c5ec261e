"""Fleet-wide patch-cache tier — a shared L2 over the replicas' L1 caches.

In the single-engine reproduction the patch cache (``core/cache.py``) lives
inside one engine, and the cluster sim prices its effect per replica
(``latency_model.CacheHitModel``), implicitly assuming every replica is
always warm for whatever it serves. Neither is true at fleet scale: a
replica that has never served a resolution has nothing to reuse — even when
a sibling holds exactly the warm patch content it needs. This module models
the missing tier:

- ``CacheTier``    — the fleet-level store. Entries are keyed by
  ``(resolution, patch_shape, step_band)`` — the unit of transferable
  patch-cache warmth: one resolution's accumulated (input, output) patch
  pairs for one band of the denoise trajectory, computed at one GCD patch
  size (entries are only interchangeable between replicas cutting latents
  the same way). Byte accounting is honest: an entry costs
  ``H x W x C x itemsize`` per latent store, and the cache keeps *two*
  stores (cached inputs for the reuse predictor + cached outputs), exactly
  like ``core.cache.PatchCache``. Capacity is enforced in bytes with
  ``lru`` or ``size_aware`` eviction. Writes are two-phase: a replica
  *begins* a write during a step and the entry only becomes fetchable when
  the write *commits* at the end of that step's busy window — a crash
  before the commit instant aborts the write (``abort_owner``), so an
  orphaned in-flight write never half-populates the store or leaks bytes.

- ``TierClient``   — one replica's view: a tiny LRU of warm keys modeling
  the engine's local (L1) patch-cache working set. A key self-warms after
  ``warmup_steps`` executed steps (the threshold predictor needs a few
  steps of stable cached inputs before reuse fires), or warms *instantly*
  by fetching a committed tier entry on the sim clock — transfer time is
  ``fetch_cost`` plus ``fetch_cost_per_byte`` times the entry's bytes, so
  High-resolution entries honestly cost more to pull than Low ones.
  Crossing the self-warm threshold publishes the entry back to the tier at
  ``write_cost``; a *warm* key whose tier entry was later evicted is
  re-published the next time it is touched (the fleet store refills from
  live working sets instead of losing the key until some replica re-warms
  from scratch). Crashes and engine migrations clear L1 (the working set
  lived in the dead/replaced process); the tier itself survives.

- Warm boot (``prefetch_on_spawn``) — the cluster driver calls
  ``TierClient.prefetch_block`` when it spawns a replica: the newest
  committed tier entries matching the replica's block (same patch size,
  its resolutions) are bulk-fetched into L1 *during* the cold start, so
  the replica's first dispatch already sees a warm cache. The transfer
  overlaps boot: the replica is ready at ``max(cold_start, transfer)``
  after spawn, and prefetch traffic is accounted separately
  (``prefetches`` / ``prefetch_time``) so it never inflates the
  steady-state hit rate.

The latency effect is priced by the two-level hit model
(``CacheHitModel.two_level_hit_rate`` via ``simtools.PatchAwareLatency``):
the per-step reuse probability is gated by the batch's L1-warm fraction,
with the cold remainder partially recovered through the tier (discounted —
a remote hit still pays fetch latency). Dispatch can exploit the same
signal: the ``cache_affinity`` router policy sends requests to the replica
whose L1 is warmest for their resolution (``router.py``).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.trace import NULL_TRACER

Resolution = Tuple[int, int]
#: (resolution, gcd patch size, step band, model-tier tag) — the unit of
#: transferable warmth. The tier tag ("" on homogeneous fleets) keeps
#: warmth per-(tier, resolution): a lite replica's warm patch content says
#: nothing about the max model's activations, so entries only ever flow
#: between replicas running the same model tier.
CacheKey = Tuple[Resolution, int, int, str]


def latent_bytes(resolution: Resolution, channels: int = 4,
                 itemsize: int = 4, stores: int = 1) -> int:
    """Bytes of one latent-shaped store for ``resolution``: H x W x C x
    itemsize, times ``stores`` (the patch cache keeps cached inputs AND
    outputs, so tier entries pass ``stores=2``; a checkpoint snapshot is a
    single latent, ``stores=1``)."""
    h, w = resolution
    return int(h) * int(w) * int(channels) * int(itemsize) * int(stores)


@dataclass
class CacheTierConfig:
    """Fleet patch-cache tier sizing and pricing.

    ``capacity_bytes <= 0`` disables the L2 store entirely (lookups always
    miss, nothing is written) while keeping the per-replica L1 warmth
    dynamics — the honest "no tier" baseline, where a cold replica can only
    self-warm. ``eviction`` picks the policy enforcing ``capacity_bytes``:
    ``lru`` evicts the least-recently-used entry; ``size_aware`` evicts the
    largest entry among the least-recently-used few (High-resolution
    entries cost proportionally more bytes, so under pressure they go
    first unless they are hot)."""
    capacity_bytes: int = 1 << 18       # 256 KiB ~= the full default ladder
    fetch_cost: float = 5e-3            # sim s per remote (res, band) fetch
    #: size-dependent fetch component: sim s per entry byte transferred.
    #: 0.0 (default) keeps the flat fetch_cost pricing bit-identical.
    fetch_cost_per_byte: float = 0.0
    write_cost: float = 2e-3            # sim s per tier publish
    #: warm boot: the driver prefetches a spawning replica's block entries
    #: from the tier during cold start (overlapped with boot)
    prefetch_on_spawn: bool = False
    eviction: str = "lru"               # lru | size_aware
    # -- warmth model (per-replica L1) ----------------------------------
    step_bands: int = 4                 # denoise trajectory bands per key
    l1_entries: int = 4                 # warm keys one replica can hold
    warmup_steps: int = 3               # self-warm steps before reuse fires
    # remote reuse recovers only part of a local hit's value (the fetch
    # sits on the step's critical path) — discount in (0, 1]
    l2_discount: float = 0.7
    # byte accounting
    channels: int = 4                   # latent channels (H x W x C)
    itemsize: int = 4                   # float32
    #: entries under the least-recently-used window size_aware picks from
    size_aware_window: int = 4

    def __post_init__(self) -> None:
        if self.eviction not in ("lru", "size_aware"):
            raise ValueError(
                f"eviction must be 'lru' or 'size_aware', got "
                f"{self.eviction!r}")
        if self.fetch_cost < 0 or self.write_cost < 0:
            raise ValueError("fetch_cost and write_cost must be >= 0")
        if self.fetch_cost_per_byte < 0:
            raise ValueError("fetch_cost_per_byte must be >= 0")
        if self.size_aware_window < 1:
            raise ValueError("size_aware_window must be >= 1")
        if self.step_bands < 1:
            raise ValueError("step_bands must be >= 1")
        if self.l1_entries < 1:
            raise ValueError("l1_entries must be >= 1")
        if self.warmup_steps < 1:
            raise ValueError("warmup_steps must be >= 1")
        if not 0.0 < self.l2_discount <= 1.0:
            raise ValueError("l2_discount must be in (0, 1]")

    def entry_bytes(self, resolution: Resolution) -> int:
        """Tier entry cost for one (resolution, patch, band) key: cached
        inputs + cached outputs, each a full latent's worth of patches."""
        return latent_bytes(resolution, self.channels, self.itemsize,
                            stores=2)

    def fetch_time(self, resolution: Resolution) -> float:
        """Sim-clock time to pull one committed tier entry for
        ``resolution``: flat ``fetch_cost`` (request overhead) plus the
        size-dependent transfer ``fetch_cost_per_byte x entry_bytes``. With
        the default ``fetch_cost_per_byte = 0`` this is exactly the legacy
        constant pricing."""
        return self.fetch_cost + self.fetch_cost_per_byte \
            * self.entry_bytes(resolution)


@dataclass
class _Pending:
    """An in-flight L2 write: begun during a step, commits at the end of
    the writing replica's busy window — unless the replica crashes first."""
    key: CacheKey
    nbytes: int
    commit_at: float
    owner: int                          # replica rid


class CacheTier:
    """The fleet-level store. Pure control plane on the sim clock: entries
    carry byte sizes and recency, not tensors (the cluster sim is
    synthetic); semantics mirror what a real latent-patch object store
    would do."""

    #: no-op by default; the cluster driver swaps in a live tracer
    tracer = NULL_TRACER

    def __init__(self, cfg: CacheTierConfig):
        self.cfg = cfg
        # key -> bytes; OrderedDict order == recency (oldest first)
        self._entries: "OrderedDict[CacheKey, int]" = OrderedDict()
        self._pending: List[_Pending] = []
        self.bytes_stored = 0
        self.bytes_peak = 0
        self.stats = {"hits": 0, "misses": 0, "writes": 0, "refreshes": 0,
                      "writes_aborted": 0, "evictions": 0,
                      "bytes_evicted": 0, "prefetches": 0}

    # ---------------- reads ----------------

    def contains(self, key: CacheKey) -> bool:
        """Side-effect-free membership probe (no recency touch, no stats) —
        used by latency *predictions*, which must not perturb the store."""
        return key in self._entries

    def pending(self, key: CacheKey) -> bool:
        """Side-effect-free probe for an in-flight (staged, uncommitted)
        write of ``key`` — lets a warm replica avoid staging a duplicate
        re-publish every step while its first one is still committing."""
        return any(p.key == key for p in self._pending)

    def committed_keys(self) -> List[CacheKey]:
        """Committed keys, newest-recency first — the order a warm-boot
        prefetch should fill a bounded L1 in."""
        return list(reversed(self._entries))

    def lookup(self, key: CacheKey, now: float) -> bool:
        """Fetch probe: hit touches recency and counts toward hit stats.
        The caller charges ``fetch_time`` on its own clock on a hit."""
        if key in self._entries:
            self._entries.move_to_end(key)
            self.stats["hits"] += 1
            if self.tracer.enabled:
                self.tracer.tier_fetch(now, key, hit=True)
            return True
        self.stats["misses"] += 1
        if self.tracer.enabled:
            self.tracer.tier_fetch(now, key, hit=False)
        return False

    def prefetch(self, key: CacheKey) -> bool:
        """Warm-boot fetch probe: touches recency like ``lookup`` (the
        entry really is read) but is counted separately — boot-time bulk
        warming must not inflate the steady-state hit rate."""
        if key in self._entries:
            self._entries.move_to_end(key)
            self.stats["prefetches"] += 1
            return True
        return False

    # ---------------- two-phase writes ----------------

    def begin_write(self, key: CacheKey, nbytes: int, commit_at: float,
                    owner: int) -> None:
        """Stage a write that becomes visible at ``commit_at`` (the writing
        replica's busy-window end). Until then the entry is fetchable by
        nobody and costs no capacity; ``abort_owner`` discards it if the
        writer crashes first."""
        if self.cfg.capacity_bytes <= 0:
            return                      # tier disabled: L1-only world
        self._pending.append(_Pending(key, int(nbytes), commit_at, owner))

    def abort_owner(self, owner: int, crash_t: float) -> int:
        """Crash handling: drop every in-flight write from ``owner`` that
        had not yet committed at ``crash_t``. Writes whose commit instant
        preceded the crash are genuinely durable and survive — exactly-once
        either way: an entry is committed once or not at all, never half."""
        keep, dropped = [], 0
        for p in self._pending:
            if p.owner == owner and p.commit_at > crash_t:
                dropped += 1
            else:
                keep.append(p)
        self._pending = keep
        self.stats["writes_aborted"] += dropped
        if self.tracer.enabled:
            self.tracer.tier_abort(crash_t, owner, dropped)
        return dropped

    def settle(self, now: float) -> None:
        """Commit every staged write that is due, then evict down to
        capacity. Driven by the cluster event loop (after the crash pass,
        so a write aborted by a same-instant crash never commits)."""
        if not self._pending:
            return
        due = [p for p in self._pending if p.commit_at <= now]
        if not due:
            return
        self._pending = [p for p in self._pending if p.commit_at > now]
        tr = self.tracer
        for p in sorted(due, key=lambda q: q.commit_at):
            if p.key in self._entries:
                # a sibling committed the same key first: refresh recency,
                # never double-count the bytes
                self._entries.move_to_end(p.key)
                self.stats["refreshes"] += 1
                continue
            self._entries[p.key] = p.nbytes
            self.bytes_stored += p.nbytes
            self.stats["writes"] += 1
            if tr.enabled:
                # committed at its own commit instant (always finite, even
                # when the driver's shutdown drain settles at t=inf)
                tr.tier_commit(p.commit_at, p.key, p.nbytes, p.owner)
        self.bytes_peak = max(self.bytes_peak, self.bytes_stored)
        # evictions happen when the last due commit lands (finite even for
        # the settle(inf) shutdown drain)
        self._evict_to_capacity(max(p.commit_at for p in due))

    def _evict_to_capacity(self, t: float) -> None:
        tr = self.tracer
        while self.bytes_stored > self.cfg.capacity_bytes and self._entries:
            if self.cfg.eviction == "lru":
                key, nbytes = next(iter(self._entries.items()))
            else:                       # size_aware
                window = list(self._entries.items())[
                    :self.cfg.size_aware_window]
                key, nbytes = max(window, key=lambda kv: kv[1])
            del self._entries[key]
            self.bytes_stored -= nbytes
            self.stats["evictions"] += 1
            self.stats["bytes_evicted"] += nbytes
            if tr.enabled:
                tr.tier_evict(t, key, nbytes)

    # ---------------- reporting ----------------

    @property
    def n_entries(self) -> int:
        return len(self._entries)

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def summary(self) -> dict:
        total = self.stats["hits"] + self.stats["misses"]
        return {
            "capacity_bytes": self.cfg.capacity_bytes,
            "bytes_stored": self.bytes_stored,
            "bytes_peak": self.bytes_peak,
            "entries": self.n_entries,
            "pending_writes": self.n_pending,
            "hit_rate": round(self.stats["hits"] / total, 4) if total
            else 0.0,
            **self.stats,
        }


@dataclass
class _L1State:
    steps: int = 0                      # executed steps with this key warm(ing)


class TierClient:
    """One replica's tier protocol + modeled L1 working set.

    The L1 is a bounded LRU of ``(resolution, patch, step_band)`` keys. A
    key's warmth grows with executed steps (``steps / warmup_steps``,
    capped at 1) — the reuse predictor needs stable cached inputs before
    reuse fires — and a committed tier entry short-circuits the warmup: one
    fetch (``fetch_cost`` on the clock) makes the key fully warm at once.
    Crossing the self-warm threshold publishes the key to the tier
    (``write_cost``, two-phase). Replicas that juggle more distinct keys
    than ``l1_entries`` thrash: evicted keys restart cold, which is exactly
    the locality pressure ``cache_affinity`` dispatch relieves."""

    def __init__(self, tier: CacheTier, rid: int,
                 cfg: Optional[CacheTierConfig] = None, patch: int = 8):
        self.tier = tier
        self.cfg = cfg or tier.cfg
        self.rid = rid
        self.patch = patch              # kept in sync by the owning Replica
        # model-tier tag in every key this client touches ("" when the
        # fleet is homogeneous); set by Replica.attach_tier on tiered
        # fleets so warmth never crosses tiers
        self.model_tier = ""
        self._l1: "OrderedDict[CacheKey, _L1State]" = OrderedDict()
        self.stats = {"l1_hits": 0, "l2_fetches": 0, "cold_misses": 0,
                      "publishes": 0, "fetch_time": 0.0, "write_time": 0.0,
                      "l1_evictions": 0, "steps_priced": 0,
                      "prefetches": 0, "prefetch_time": 0.0,
                      "republishes": 0}

    # ---------------- key geometry ----------------

    def band_of(self, steps_done: int, total_steps: int) -> int:
        frac = steps_done / max(total_steps, 1)
        return min(int(frac * self.cfg.step_bands), self.cfg.step_bands - 1)

    def _key(self, req) -> CacheKey:
        return (tuple(req.resolution), self.patch,
                self.band_of(req.steps_done, req.total_steps),
                self.model_tier)

    def _weight(self, key: CacheKey) -> float:
        """Warmth in [0, 1] of one key: fraction of the warmup served."""
        st = self._l1.get(key)
        if st is None:
            return 0.0
        return min(st.steps / self.cfg.warmup_steps, 1.0)

    # ---------------- read-only views (prediction + dispatch) ------------

    def warm_fractions(self, reqs: Sequence) -> Tuple[float, float]:
        """(l1_frac, l2_frac) for a hypothetical batch, patch-weighted:
        l1_frac is the warm share of the batch's keys, l2_frac the share of
        the cold remainder a committed tier entry could recover. Pure read
        — latency predictions must not mutate cache state."""
        weights: Dict[CacheKey, float] = {}
        for r in reqs:
            h, w = r.resolution
            npatch = (h // self.patch) * (w // self.patch)
            key = self._key(r)
            weights[key] = weights.get(key, 0.0) + max(npatch, 1)
        total = sum(weights.values())
        if total <= 0:
            return 0.0, 0.0
        l1 = sum(wt * self._weight(k) for k, wt in weights.items()) / total
        cold = {k: wt * (1.0 - self._weight(k))
                for k, wt in weights.items()}
        cold_total = sum(cold.values())
        if cold_total <= 0:
            return l1, 0.0
        l2 = sum(wt for k, wt in cold.items()
                 if self.tier.contains(k)) / cold_total
        return l1, l2

    def warmth(self, resolution: Resolution) -> float:
        """Mean warmth across this resolution's step bands at the current
        patch — the ``cache_affinity`` dispatch signal."""
        res = tuple(resolution)
        return sum(self._weight((res, self.patch, b, self.model_tier))
                   for b in range(self.cfg.step_bands)) / self.cfg.step_bands

    # ---------------- effectful transition (one executed step) -----------

    def on_step(self, stepped_reqs: Sequence, now: float,
                step_end: float) -> float:
        """Advance L1 warmth for the batch that just executed and run the
        tier protocol for its cold keys: fetch committed entries
        (``fetch_time`` each — flat cost plus size-dependent transfer),
        publish keys that just self-warmed and re-publish warm keys the L2
        lost (``write_cost`` each). Returns the sim-clock cost to add to the
        step's busy horizon. ``step_end`` is the busy end *before* tier
        costs; staged publishes commit at ``step_end`` plus everything
        this call charged — i.e. exactly the writer's final busy-window
        end, so a crash at any instant the replica is still busy aborts
        them.

        The batch's keys are derived from pre-step progress (the engine has
        already advanced ``steps_done``), so the effectful transition and
        the latency prediction that priced this step agree on the keys."""
        cfg = self.cfg
        keys: "OrderedDict[CacheKey, None]" = OrderedDict()
        for r in stepped_reqs:
            band = self.band_of(max(r.steps_done - 1, 0), r.total_steps)
            keys.setdefault((tuple(r.resolution), self.patch, band,
                             self.model_tier))
        extra = 0.0
        publishes: List[CacheKey] = []
        self.stats["steps_priced"] += 1
        for key in keys:
            st = self._l1.get(key)
            if st is not None and st.steps >= cfg.warmup_steps:
                self.stats["l1_hits"] += 1
                st.steps += 1
                self._l1.move_to_end(key)
                if self.tier.cfg.capacity_bytes > 0 \
                        and not self.tier.contains(key) \
                        and not self.tier.pending(key):
                    # the L2 evicted (or a crash aborted) this entry while
                    # we stayed warm: re-publish so the fleet store refills
                    # from a live working set instead of losing the key
                    publishes.append(key)
                    self.stats["republishes"] += 1
                    self.stats["write_time"] += cfg.write_cost
                    extra += cfg.write_cost
                continue
            if self.tier.lookup(key, now):
                # committed fleet entry: one fetch makes the key warm now
                cost = cfg.fetch_time(key[0])
                self.stats["l2_fetches"] += 1
                self.stats["fetch_time"] += cost
                extra += cost
                self._l1[key] = _L1State(steps=cfg.warmup_steps)
                self._l1.move_to_end(key)
            else:
                self.stats["cold_misses"] += 1
                if st is None:
                    st = self._l1[key] = _L1State()
                st.steps += 1
                self._l1.move_to_end(key)
                if st.steps == cfg.warmup_steps \
                        and self.tier.cfg.capacity_bytes > 0:
                    # just self-warmed: publish for the fleet (two-phase;
                    # staged below once this call's total cost is known).
                    # With the tier disabled (capacity 0) there is nothing
                    # to publish to and no write cost to pay.
                    publishes.append(key)
                    self.stats["publishes"] += 1
                    self.stats["write_time"] += cfg.write_cost
                    extra += cfg.write_cost
            while len(self._l1) > cfg.l1_entries:
                self._l1.popitem(last=False)
                self.stats["l1_evictions"] += 1
        for key in publishes:
            # commits exactly when the replica's busy window — engine step
            # + every fetch/write charged this call — actually ends
            self.tier.begin_write(key, cfg.entry_bytes(key[0]),
                                  commit_at=step_end + extra,
                                  owner=self.rid)
        return extra

    # ---------------- warm boot (spawn prefetch) ----------------

    def prefetch_block(self, resolutions: Sequence[Resolution],
                       now: float) -> Tuple[int, int, float]:
        """Bulk-warm this (spawning) replica's L1 from the tier: fetch the
        newest committed entries matching the replica's block — same patch
        size, one of its ``resolutions`` — newest-recency first, up to
        ``l1_entries``. Returns ``(n_keys, n_bytes, transfer_time)``; the
        caller (the cluster driver's spawn path) overlaps ``transfer_time``
        with the cold start and extends ``ready_at`` only if the transfer
        outlasts the boot. Counted as ``prefetches``/``prefetch_time``,
        never as steady-state hits — warm-boot traffic must not flatter
        the tier's hit rate."""
        cfg = self.cfg
        if self.tier.cfg.capacity_bytes <= 0:
            return 0, 0, 0.0            # no tier, nothing to boot from
        want = {tuple(r) for r in resolutions}
        picked: List[CacheKey] = []
        for key in self.tier.committed_keys():
            res, patch, _band, tag = key
            if patch == self.patch and tag == self.model_tier \
                    and tuple(res) in want:
                picked.append(key)
                if len(picked) >= cfg.l1_entries:
                    break
        nbytes, transfer = 0, 0.0
        for key in picked:
            self.tier.prefetch(key)
            cost = cfg.fetch_time(key[0])
            self._l1[key] = _L1State(steps=cfg.warmup_steps)
            self._l1.move_to_end(key)
            nbytes += cfg.entry_bytes(key[0])
            transfer += cost
            self.stats["prefetches"] += 1
            self.stats["prefetch_time"] += cost
        while len(self._l1) > cfg.l1_entries:
            self._l1.popitem(last=False)
            self.stats["l1_evictions"] += 1
        return len(picked), nbytes, transfer

    # ---------------- lifecycle ----------------

    def on_crash(self, now: float) -> None:
        """The replica died: its L1 working set is gone and its in-flight
        L2 writes must not commit (exactly-once — a half-written entry
        never becomes fetchable)."""
        self._l1.clear()
        self.tier.abort_owner(self.rid, now)

    def on_switch(self, patch: int) -> None:
        """Engine swapped (repartition migration): the local patch cache is
        rebuilt from scratch over the new block's patch size. Committed and
        in-flight tier writes stand — the replica is alive and the data it
        published was real."""
        self._l1.clear()
        self.patch = patch

    @property
    def warm_keys(self) -> List[CacheKey]:
        return [k for k in self._l1 if self._weight(k) >= 1.0]


def aggregate_client_stats(clients: Sequence[Optional[TierClient]]) -> dict:
    """Fold per-replica TierClient stats into one fleet view (hit shares of
    all priced L1 decisions, fetch/write clock time)."""
    tot: Dict[str, float] = {"l1_hits": 0, "l2_fetches": 0, "cold_misses": 0,
                             "publishes": 0, "fetch_time": 0.0,
                             "write_time": 0.0, "l1_evictions": 0,
                             "steps_priced": 0, "prefetches": 0,
                             "prefetch_time": 0.0, "republishes": 0}
    for c in clients:
        if c is None:
            continue
        for k in tot:
            tot[k] += c.stats[k]
    touches = tot["l1_hits"] + tot["l2_fetches"] + tot["cold_misses"]
    out = {k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in tot.items()}
    out["l1_hit_rate"] = round(tot["l1_hits"] / touches, 4) if touches \
        else 0.0
    out["l2_hit_rate"] = round(tot["l2_fetches"] / touches, 4) if touches \
        else 0.0
    return out
