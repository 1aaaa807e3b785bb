"""Cache pools for the serving engine.

``CachePool`` pre-allocates every decode slot's dense cache for every
ensemble member: the leaves of ``model.make_cache(cfg, batch=num_slots,
max_seq)`` (attention k/v, RG-LRU state) with a leading member axis, and a
per-slot position ``t`` of shape (K, num_slots).  It is allocated ONCE at
engine construction;
admissions and completions recycle slots by index.  (The reference pools
one batch-1 cache per slot; here the slot axis is the cache's batch axis,
so a member decodes every slot in one call.)

``PagedCachePool`` is the block-paged alternative: KV lives in a flat pool
of fixed-size pages handed out by the host-side ``BlockAllocator`` (a copy
of the reference's: freelist + refcounted prefix sharing + worst-case
growth reservations).  Block tables and context lengths stay host-resident
numpy and are copied to the device every tick.

Slots can be parked (lifted out of the live pool) and restored.  With
``compress_parked=True`` a parked slot's float leaves go through the int8
block codec (``distributed.int8_codec``; about 4x smaller than f32, 2x
than bf16) and come back within its error bound; int leaves stay exact.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.distributed.compression import int8_codec
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.obs import trace as obs_trace

_CODEC = int8_codec()


def _pack(x, compress: bool):
    """A parked leaf: the int8 encoding of a float tensor when ``compress``,
    else the tensor."""
    return _CODEC.encode(x) if compress and x.is_floating_point() else x


def _unpack(x):
    return _CODEC.decode(x) if isinstance(x, dict) else x


def _batch_leaves(tree, stacked: bool = False):
    """(parent dict, key, batch axis) for each leaf of a make_cache tree:
    attention k/v and RG-LRU h/conv alike (batch axis 1 under the stacked
    "layers", 0 under "rem"); ``t`` is skipped."""
    for key, sub in tree.items():
        if isinstance(sub, dict):
            yield from _batch_leaves(sub, stacked or key == "layers")
        elif key != "t":
            yield tree, key, 1 if stacked else 0


class ParkedCache(NamedTuple):
    """A slot's cache lifted out of the live pool: per cache leaf, the
    (K, ...) slice of that slot, in ``_batch_leaves`` order (an int8
    encoding when ``compressed``), plus ``t``."""

    leaves: list
    t: Any
    compressed: bool = False


class CachePool:
    """Pre-allocated dense cache pool with free-list recycling.

    ``caches`` leaves are (K, [n_periods,] num_slots, ...): attention k/v
    (..., L, Hkv, dh), RG-LRU h (..., R) and conv (..., W-1, R); and
    ``caches["t"]`` is (K, num_slots).  ``member(k)`` is member k's view, a
    ``make_cache``-shaped tree whose ``t`` is (num_slots,); decode steps
    write through it in place."""

    def __init__(
        self,
        cfg,
        model,
        *,
        num_members: int,
        num_slots: int,
        max_seq: int,
        dtype=None,
        compress_parked: bool = False,
        device="cuda",
    ):
        if num_members < 1 or num_slots < 1:
            raise ValueError("num_members and num_slots must be >= 1")
        self.compress_parked = bool(compress_parked)
        self.num_members = int(num_members)
        self.num_slots = int(num_slots)
        self.max_seq = int(max_seq)
        proto = model.make_cache(cfg, self.num_slots, max_seq, dtype or cfg.compute_dtype, "meta")
        self.caches = tree_map(
            lambda s: torch.zeros((self.num_members,) + tuple(s.shape), dtype=s.dtype, device=device),
            proto,
        )
        self.caches["t"] = torch.zeros((self.num_members, self.num_slots), dtype=torch.int32,
                                       device=device)
        self._free = list(range(self.num_slots - 1, -1, -1))  # pop() -> slot 0 first
        self.acquired = 0
        self.released = 0
        self.high_water = 0

    def member(self, k: int):
        return tree_map(lambda a: a[k], self.caches)

    def write_slot(self, k: int, slot: int, slot_cache) -> None:
        """Copy a batch-1 cache (from ``prefill``) into member k's ``slot``."""
        view = self.member(k)
        for (dst, key, ax), (src, skey, _) in zip(_batch_leaves(view), _batch_leaves(slot_cache)):
            dst[key].select(ax, slot).copy_(src[skey].select(ax, 0))
        self.caches["t"][k, slot] = slot_cache["t"]

    # -- slot bookkeeping ---------------------------------------------------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return self.num_slots - len(self._free)

    def acquire(self) -> int:
        """Claim a free slot index; raises IndexError when the pool is full
        (the scheduler checks ``free_slots`` before admitting)."""
        slot = self._free.pop()
        self.acquired += 1
        self.high_water = max(self.high_water, self.active_slots)
        return slot

    def release(self, slot: int) -> None:
        if slot in self._free or not (0 <= slot < self.num_slots):
            raise ValueError(f"release of non-acquired slot {slot}")
        self._free.append(slot)
        self.released += 1

    # -- park / restore -----------------------------------------------------

    def park(self, slot: int, *, release: bool = True) -> ParkedCache:
        """Copy slot ``slot``'s cache out of the live pool, through the int8
        codec with ``compress_parked``; ``release`` frees the slot."""
        with obs_trace.get().span("pool.park", cat="pool", slot=slot):
            leaves = [_pack(parent[key].select(ax + 1, slot).clone(), self.compress_parked)
                      for parent, key, ax in _batch_leaves(self.caches)]
            t = self.caches["t"][:, slot].clone()
            if release:
                self.release(slot)
            return ParkedCache(leaves, t, self.compress_parked)

    def restore(self, parked: ParkedCache, slot: int | None = None) -> int:
        """Write a parked cache back into ``slot`` (or a newly acquired
        one); returns the slot index."""
        if slot is None:
            slot = self.acquire()
        with obs_trace.get().span("pool.restore", cat="pool", slot=slot):
            for (parent, key, ax), x in zip(_batch_leaves(self.caches), parked.leaves):
                parent[key].select(ax + 1, slot).copy_(_unpack(x))
            self.caches["t"][:, slot] = parked.t
            return slot

    @property
    def compressed_parking(self) -> bool:
        return self.compress_parked

    def can_admit(self, prompt, max_new: int, version: int = 0) -> bool:
        """Dense slots always fit a request that passed the max_seq guard."""
        del prompt, max_new, version
        return True

    def stats(self) -> dict:
        return {
            "num_slots": self.num_slots,
            "active": self.active_slots,
            "high_water": self.high_water,
            "acquired": self.acquired,
            "released": self.released,
        }


# ---------------------------------------------------------------------------
# Block-paged pool
# ---------------------------------------------------------------------------


def _blocks_for(positions: int, block_size: int) -> int:
    return -(-max(int(positions), 0) // block_size)


class BlockAllocator:
    """Host-side page bookkeeping for the paged KV pool.

    Pure python/numpy — no device state — so the allocator invariants are
    property-testable at interleaving granularity (the reference's tests/test_paged_cache.py).

    Contract:
      * page 0 is the reserved SINK: never allocated, never freed; free/done
        slots' decode writes are redirected there and nothing reads it.
      * ``tables`` (num_slots, M) int32 rows map a slot's logical blocks to
        pages; allocated entries form a contiguous prefix of the row, the
        rest is sink.  ``ctx`` (num_slots,) is the slot's current position.
      * prefix sharing: the FULL prompt blocks (``plen // bs`` of them) of
        a prompt are registered under (registry_version, prompt bytes); a
        later admit with the same key increfs those pages instead of
        allocating.  Every sharer holds a reference on every shared page,
        so an entry's refcounts move in lockstep and pages are freed
        exactly once, when the last sharer releases.
      * admission is AIRTIGHT: ``can_admit`` charges the request's whole
        worst-case growth (``plen + max_new - 1`` positions) against
        ``free - outstanding reservations``, so a request that admits can
        never hit pool exhaustion mid-decode.
    """

    def __init__(self, *, num_blocks: int, block_size: int, max_seq: int,
                 num_slots: int, prefix_sharing: bool = True):
        if block_size < 1 or num_slots < 1:
            raise ValueError("block_size and num_slots must be >= 1")
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (page 0 is the sink)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_seq = int(max_seq)
        self.num_slots = int(num_slots)
        self.prefix_sharing = bool(prefix_sharing)
        self.blocks_per_slot = _blocks_for(max_seq, block_size)  # M
        self._free = list(range(self.num_blocks - 1, 0, -1))  # pop() -> page 1 first
        self.refcount = np.zeros(self.num_blocks, np.int32)
        self.tables = np.zeros((self.num_slots, self.blocks_per_slot), np.int32)
        self.ctx = np.zeros((self.num_slots,), np.int32)
        self._owned: dict[int, list] = {}
        self._reserved: dict[int, int] = {}
        self._prefix: dict = {}  # key -> list of page ids
        self._block_prefix: dict = {}  # page id -> key (a page is in <= 1 entry)
        self.blocks_high_water = 0
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.shared_block_hits = 0
        self.prefix_invalidated = 0

    # -- internals ----------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    @property
    def reserved_blocks(self) -> int:
        return sum(self._reserved.values())

    def _alloc(self) -> int:
        if not self._free:
            raise RuntimeError("page pool exhausted (admission gate broken?)")
        b = self._free.pop()
        self.refcount[b] = 1
        self.blocks_high_water = max(self.blocks_high_water, self.used_blocks)
        return b

    def _decref(self, b: int) -> None:
        self.refcount[b] -= 1
        if self.refcount[b] < 0:
            raise RuntimeError(f"page {b} refcount underflow")
        if self.refcount[b] == 0:
            key = self._block_prefix.pop(b, None)
            if key is not None:
                self._prefix.pop(key, None)
            self._free.append(b)

    def invalidate_version(self, version: int) -> int:
        """Eagerly drop prefix-sharing entries from superseded registry
        versions.  Entries are keyed on ``(registry_version, prompt bytes)``,
        so after a promotion the old-version entries can never be hit again —
        without this they linger (holding their ``_block_prefix``
        back-pointers) until the last sharer happens to exit.  Current
        sharers are untouched: pages stay refcounted by their slots and are
        freed exactly once, by the existing ``_decref`` path (which tolerates
        the missing back-pointer).  Returns the number of entries dropped."""
        stale = [k for k in self._prefix if k[0] != int(version)]
        for k in stale:
            for b in self._prefix.pop(k):
                self._block_prefix.pop(b, None)
        self.prefix_invalidated += len(stale)
        return len(stale)

    def _prefix_key(self, prompt: np.ndarray, version: int):
        n_full = prompt.size // self.block_size
        if not (self.prefix_sharing and n_full):
            return None, 0
        return (int(version), prompt[: n_full * self.block_size].tobytes()), n_full

    # -- admission ----------------------------------------------------------

    def can_admit(self, prompt, max_new: int, version: int = 0) -> bool:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        total = _blocks_for(prompt.size + max_new - 1, self.block_size)
        if total > self.blocks_per_slot:
            return False
        now = _blocks_for(prompt.size, self.block_size)
        key, n_full = self._prefix_key(prompt, version)
        shared = n_full if (key is not None and key in self._prefix) else 0
        need = (now - shared) + (total - now)
        return need <= len(self._free) - self.reserved_blocks

    def admit(self, slot: int, prompt, max_new: int, version: int = 0) -> np.ndarray:
        """Map ``prompt`` into pages for ``slot``; returns the (M,) int32
        table row.  Callers gate on :meth:`can_admit` first — exhaustion
        here means the reservation accounting is broken."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if slot in self._owned:
            raise ValueError(f"slot {slot} already admitted")
        now = _blocks_for(prompt.size, self.block_size)
        total = _blocks_for(prompt.size + max_new - 1, self.block_size)
        if total > self.blocks_per_slot:
            raise ValueError(
                f"prompt_len + max_new needs {total} blocks > "
                f"blocks_per_slot={self.blocks_per_slot}"
            )
        key, n_full = self._prefix_key(prompt, version)
        row = np.zeros(self.blocks_per_slot, np.int32)
        owned: list = []
        if key is not None:
            self.prefix_queries += 1
            entry = self._prefix.get(key)
            if entry is not None:
                self.prefix_hits += 1
                self.shared_block_hits += n_full
                for j, b in enumerate(entry):
                    self.refcount[b] += 1
                    row[j] = b
                    owned.append(b)
            else:
                entry = [self._alloc() for _ in range(n_full)]
                for j, b in enumerate(entry):
                    row[j] = b
                    owned.append(b)
                    self._block_prefix[b] = key
                self._prefix[key] = entry
            start = n_full
        else:
            start = 0
        for j in range(start, now):
            b = self._alloc()
            row[j] = b
            owned.append(b)
        self.tables[slot] = row
        self.ctx[slot] = prompt.size
        self._owned[slot] = owned
        self._reserved[slot] = total - now
        obs_trace.get().instant(
            "alloc.reserve", cat="alloc", slot=slot, pages=len(owned),
            reserved=total - now, free=len(self._free),
        )
        return row

    # -- decode-time growth --------------------------------------------------

    def ensure_decode_block(self, slot: int) -> None:
        """Guarantee the page holding position ``ctx[slot]`` exists before a
        decode tick writes there (draws down this slot's reservation)."""
        if slot not in self._owned:
            raise ValueError(f"slot {slot} not admitted")
        j = int(self.ctx[slot]) // self.block_size
        if j >= self.blocks_per_slot:
            raise RuntimeError(
                f"slot {slot} position {int(self.ctx[slot])} overflows "
                f"max_seq={self.max_seq} (engine guard breached)"
            )
        if self.tables[slot, j] == 0:
            b = self._alloc()
            self.tables[slot, j] = b
            self._owned[slot].append(b)
            self._reserved[slot] = max(0, self._reserved[slot] - 1)
            obs_trace.get().instant("alloc.grow", cat="alloc", slot=slot, page=b)

    def advance(self, slot: int) -> None:
        self.ctx[slot] += 1

    # -- release -------------------------------------------------------------

    def release(self, slot: int) -> None:
        if slot not in self._owned:
            raise ValueError(f"release of non-admitted slot {slot}")
        owned = self._owned.pop(slot)
        for b in owned:
            self._decref(b)
        self.tables[slot] = 0
        self.ctx[slot] = 0
        self._reserved.pop(slot, None)
        obs_trace.get().instant(
            "alloc.free", cat="alloc", slot=slot, pages=len(owned),
            free=len(self._free),
        )

    # -- invariants (property-test surface) ----------------------------------

    def check(self) -> None:
        """Raise AssertionError on any broken freelist/refcount invariant."""
        free = self._free
        assert len(set(free)) == len(free), "duplicate pages in freelist"
        assert all(0 < b < self.num_blocks for b in free), "sink/oob page freed"
        assert all(self.refcount[b] == 0 for b in free), "freed page still referenced"
        assert self.refcount[0] == 0, "sink page acquired a refcount"
        in_use = {int(b) for bs_ in self._owned.values() for b in bs_}
        assert 0 not in in_use, "sink page owned by a slot"
        assert len(free) + len(in_use) == self.num_blocks - 1, "page leak/double-book"
        counts: dict[int, int] = {}
        for blocks in self._owned.values():
            assert len(set(blocks)) == len(blocks), "slot owns a page twice"
            for b in blocks:
                counts[b] = counts.get(b, 0) + 1
        for b, c in counts.items():
            assert self.refcount[b] == c, f"page {b}: refcount {self.refcount[b]} != owners {c}"
        for slot, blocks in self._owned.items():
            row = self.tables[slot]
            nz = row[row != 0]
            assert list(nz) == [b for b in row[: len(nz)]], "table row not prefix-contiguous"
            assert set(int(b) for b in nz) == set(blocks), "table row != owned pages"
        assert all(v >= 0 for v in self._reserved.values()), "negative reservation"

    def stats(self) -> dict:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_used": self.used_blocks,
            "blocks_free": len(self._free),
            "blocks_high_water": self.blocks_high_water,
            "blocks_reserved": self.reserved_blocks,
            "prefix_queries": self.prefix_queries,
            "prefix_hits": self.prefix_hits,
            "shared_block_hits": self.shared_block_hits,
            "prefix_invalidated": self.prefix_invalidated,
        }


class PagedParked(NamedTuple):
    """One slot's pages lifted out of the paged pool (gathered in logical
    block order; int8 encodings when ``compressed``)."""

    leaves: list
    ctx: int
    num_pages: int
    compressed: bool = False


def _page_axis(leaf) -> int:
    # member-stacked pool leaves are (K, [n_periods,] num_pages, bs, Hkv, dh):
    # the page axis always sits 4 dims from the end
    return leaf.ndim - 4


class PagedCachePool:
    """Block-paged drop-in for :class:`CachePool`.

    Device state is one nested dict of flat page pools with a leading
    member axis: each leaf of ``model.paged.make_pools`` pooled to
    ``(K, [n_periods,] num_pages, block_size, Hkv, dh)``.  Slot occupancy,
    block tables, context lengths, refcounts and reservations are host-side
    numpy in ``self.alloc``.
    """

    def __init__(
        self,
        cfg,
        model,
        *,
        num_members: int,
        num_slots: int,
        max_seq: int,
        block_size: int = 16,
        num_blocks: int | None = None,
        dtype=None,
        compress_parked: bool = False,
        prefix_sharing: bool = True,
        device="cuda",
    ):
        if model.paged is None:
            raise ValueError("model has no paged decode surface (ModelDef.paged is None)")
        if num_members < 1 or num_slots < 1:
            raise ValueError("num_members and num_slots must be >= 1")
        model.paged.check_support(cfg)
        self.compress_parked = bool(compress_parked)
        self.cfg, self.model = cfg, model
        self.num_members = int(num_members)
        self.num_slots = int(num_slots)
        self.max_seq = int(max_seq)
        self.block_size = int(block_size)
        M = _blocks_for(max_seq, block_size)
        if num_blocks is None:
            num_blocks = num_slots * M + 1  # worst case concurrency + sink
        self.alloc = BlockAllocator(
            num_blocks=num_blocks, block_size=block_size, max_seq=max_seq,
            num_slots=num_slots, prefix_sharing=prefix_sharing,
        )
        proto = model.paged.make_pools(cfg, num_blocks, block_size,
                                       dtype or cfg.compute_dtype, "meta")
        self.caches = tree_map(
            lambda s: torch.zeros((self.num_members,) + tuple(s.shape), dtype=s.dtype, device=device),
            proto,
        )
        self._bytes_per_page = sum(
            leaf.numel() * leaf.element_size() // num_blocks for leaf in tree_leaves(self.caches)
        )
        self._free = list(range(self.num_slots - 1, -1, -1))
        self.acquired = 0
        self.released = 0
        self.high_water = 0

    def member(self, k: int):
        return tree_map(lambda a: a[k], self.caches)

    # -- slot bookkeeping (CachePool-compatible surface) ---------------------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def tables(self) -> np.ndarray:
        return self.alloc.tables

    @property
    def ctx(self) -> np.ndarray:
        return self.alloc.ctx

    def acquire(self) -> int:
        slot = self._free.pop()
        self.acquired += 1
        self.high_water = max(self.high_water, self.active_slots)
        return slot

    def release(self, slot: int) -> None:
        if slot in self._free or not (0 <= slot < self.num_slots):
            raise ValueError(f"release of non-acquired slot {slot}")
        if slot in self.alloc._owned:
            self.alloc.release(slot)
        self._free.append(slot)
        self.released += 1

    # -- admission / growth ---------------------------------------------------

    def can_admit(self, prompt, max_new: int, version: int = 0) -> bool:
        return self.alloc.can_admit(prompt, max_new, version)

    def admit_blocks(self, slot: int, prompt, max_new: int, version: int = 0) -> np.ndarray:
        return self.alloc.admit(slot, prompt, max_new, version)

    def ensure_decode_block(self, slot: int) -> None:
        self.alloc.ensure_decode_block(slot)

    def advance(self, slot: int) -> None:
        self.alloc.advance(slot)

    def invalidate_version(self, version: int) -> int:
        """Drop prefix entries superseded by a registry promotion."""
        return self.alloc.invalidate_version(version)

    # -- park / restore -------------------------------------------------------

    def _slot_pages(self, slot: int) -> list:
        row = self.alloc.tables[slot]
        return [int(b) for b in row[row != 0]]

    def park(self, slot: int, *, release: bool = True) -> PagedParked:
        """Gather (copy) this slot's pages out of the pool in logical block
        order, through the int8 codec with ``compress_parked``.  Shared
        prefix pages are COPIED, not moved."""
        with obs_trace.get().span("pool.park", cat="pool", slot=slot):
            pages = self._slot_pages(slot)
            leaves = []
            for leaf in tree_leaves(self.caches):
                idx = torch.tensor(pages, dtype=torch.long, device=leaf.device)
                leaves.append(_pack(torch.index_select(leaf, _page_axis(leaf), idx),
                                    self.compress_parked))
            ctx = int(self.alloc.ctx[slot])
            if release:
                self.release(slot)
            return PagedParked(leaves, ctx, len(pages), self.compress_parked)

    def restore(self, parked: PagedParked, slot: int | None = None,
                max_new: int = 1) -> int:
        """Allocate fresh pages for a parked cache and scatter it back;
        returns the slot.  ``max_new`` re-reserves the request's remaining
        growth."""
        if len(self.alloc._free) < parked.num_pages:
            raise RuntimeError("not enough free pages to restore parked cache")
        if slot is None:
            slot = self.acquire()
        with obs_trace.get().span("pool.restore", cat="pool", slot=slot):
            a = self.alloc
            if slot in a._owned:
                raise ValueError(f"slot {slot} already holds pages")
            pages = [a._alloc() for _ in range(parked.num_pages)]
            row = np.zeros(a.blocks_per_slot, np.int32)
            row[: len(pages)] = pages
            a.tables[slot] = row
            a.ctx[slot] = parked.ctx
            a._owned[slot] = list(pages)
            total = _blocks_for(parked.ctx + max_new - 1, self.block_size)
            a._reserved[slot] = max(0, total - len(pages))
            for leaf, vals in zip(tree_leaves(self.caches), parked.leaves):
                idx = torch.tensor(pages, dtype=torch.long, device=leaf.device)
                leaf.index_copy_(_page_axis(leaf), idx, _unpack(vals).to(leaf.dtype))
            return slot

    @property
    def compressed_parking(self) -> bool:
        return self.compress_parked

    # -- stats ----------------------------------------------------------------

    @property
    def bytes_per_page(self) -> int:
        return self._bytes_per_page

    def stats(self) -> dict:
        a = self.alloc.stats()
        return {
            "num_slots": self.num_slots,
            "active": self.active_slots,
            "high_water": self.high_water,
            "acquired": self.acquired,
            "released": self.released,
            "paged": True,
            "bytes_per_page": self._bytes_per_page,
            "bytes_used": a["blocks_used"] * self._bytes_per_page,
            "bytes_high_water": a["blocks_high_water"] * self._bytes_per_page,
            "bytes_total": (a["num_blocks"] - 1) * self._bytes_per_page,
            "prefix_hit_rate": (
                a["prefix_hits"] / a["prefix_queries"] if a["prefix_queries"] else 0.0
            ),
            **a,
        }
