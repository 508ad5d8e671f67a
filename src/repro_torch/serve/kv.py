"""Paged KV cache: free-list block allocator, per-slot block tables, and
copy-on-write prefix sharing — the port of ``repro.serve.kv``.

The contiguous cache provisions every slot a private ``max_len`` lane, so
KV capacity scales with the worst case and the mapper never sees KV
traffic. Here KV storage is one shared pool of fixed-size blocks —
``[num_blocks, block_size, n_kv_heads, head_dim]`` per attention site —
and a slot owns a *block table*: logical position ``p`` lives at offset
``p % block_size`` of physical block ``table[p // block_size]``. Slot
count is decoupled from ``max_len``; capacity is provisioned for the
*observed* working set.

Sharing model (copy-on-write):
  * every **full** block whose tokens are entirely prompt is
    content-addressed by the hash of the whole prompt prefix up to and
    including it; a later request whose prompt extends the same prefix
    attaches the cached blocks by reference (refcount++) instead of
    recomputing them — the engine then skips replaying those prompt
    tokens entirely;
  * shared blocks are immutable: a write landing in a block with
    refcount > 1 (e.g. after :meth:`fork_slot`) first copies it to a
    fresh block (``ensure`` performs the copy-on-write);
  * blocks whose refcount drops to zero but that still back a cached
    prefix stay resident and evictable (LRU) — the pool reclaims them
    only when the free list runs dry.

Physical block 0 is a pinned scratch block: inactive batch lanes write
there and unallocated table entries clamp to it, so the one batched
decode call stays shape-static while never corrupting live blocks (reads
from it are masked by the per-slot position bound).

Preemption support (:meth:`swap_out` / :meth:`swap_in`): a victim slot's
pages are copied to host scratch and its blocks returned to the pool;
resuming re-attaches any still-cached prefix blocks by reference and
restores only the remainder from scratch, bit-exactly. Cross-engine
prefix migration (:meth:`export_prefix` / :meth:`import_prefix`) moves a
cached prefix chain between two pools holding the same model's KV — the
reference's router uses it to make a prefix cached on engine A servable
from B.

The allocator is host-side metadata only; the device storage — a dict
(possibly nested) of tensors whose block axis is 1, e.g. the model's
``{"k", "v"}`` pool ``[n_layers, num_blocks, block_size, G, head_dim]`` —
is passed to the methods that touch it. Where the reference returns an
updated copy of the storage, the port writes it in place and returns the
same object, so calls read as they do in the reference. Only unquantized
pools (``kv_dtype="fp32"``) are ported. ``device_table()`` materializes
the clamped ``[slots, max_blocks]`` int32 table the paged attention kernel
reads through.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device

SCRATCH_BLOCK = 0


def _require_unquantized(kv_dtype: str) -> None:
    if kv_dtype != "fp32":
        raise NotImplementedError(
            f"kv_dtype={kv_dtype!r}: quantized KV pools are not ported yet "
            f"(ROADMAP.md, port queue item 2: quantized KV serving)")


def _host_copy(bid: int):
    """Leaf function: a host copy of block ``bid`` (a copy even when the
    pool is on the CPU, so later writes to the pool cannot reach it)."""
    return lambda a: a[:, bid].to("cpu", copy=True)


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of a dict tree (and of ``rest``,
    trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def kv_token_bits(n_kv: int, head_dim: int, kv_dtype: str = "fp32") -> int:
    """Bits one token's K+V entries occupy at one attention site."""
    _require_unquantized(kv_dtype)
    return 2 * n_kv * head_dim * 32


def kv_token_bytes(n_kv: int, head_dim: int, sites: int,
                   kv_dtype: str = "fp32") -> int:
    """Pool bytes one token occupies across all attention sites."""
    _require_unquantized(kv_dtype)
    return sites * 2 * n_kv * head_dim * 4


class KVCacheOOM(RuntimeError):
    """The paged KV pool has no free (or evictable) block left."""


@dataclasses.dataclass
class _SlotMeta:
    """Host bookkeeping for one admitted slot."""

    chain_keys: list[bytes]       # prefix hash per full prompt block
    prompt_blocks: int            # blocks holding only prompt tokens


@dataclasses.dataclass
class SwappedPages:
    """Host-side scratch copy of a preempted slot's KV pages.

    ``pages`` maps each occupied table index to the per-leaf host tensors
    of its physical block (one ``[n_layers, block_size, n_kv, head_dim]``
    slab per leaf); the blocks themselves went back to the pool when the
    slot was swapped out."""

    pages: list[tuple[int, object]]     # (table index, host tensor tree)

    @property
    def n_blocks(self) -> int:
        return len(self.pages)


class PagedKVCache:
    """Block allocator + prefix index over a paged KV pool.

    ``num_blocks`` counts physical blocks *including* the pinned scratch
    block 0; ``slots`` is the engine's batch width; ``max_len`` bounds one
    request's total length (it sizes the per-slot table, not the pool);
    ``device`` is where ``device_table()`` lives (CUDA by default).
    """

    def __init__(self, num_blocks: int, block_size: int, slots: int,
                 max_len: int, kv_dtype: str = "fp32", *,
                 device: str | torch.device | None = None):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (block 0 is the pinned "
                             f"scratch block), got {num_blocks}")
        if block_size < 1 or slots < 1 or max_len < 1:
            raise ValueError("block_size, slots and max_len must be >= 1")
        _require_unquantized(kv_dtype)
        self.kv_dtype = kv_dtype
        self.device = resolve_device(device)
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.slots = slots
        self.max_len = max_len
        self.max_blocks = math.ceil(max_len / block_size)
        self.table = np.full((slots, self.max_blocks), -1, np.int32)
        self.ref = np.zeros(num_blocks, np.int64)
        self.ref[SCRATCH_BLOCK] = 1            # pinned, never allocated
        self._free: collections.deque[int] = collections.deque(
            range(1, num_blocks))
        self._prefix: dict[bytes, int] = {}    # chain hash -> block id
        self._block_key: dict[int, bytes] = {} # block id -> chain hash
        # ref==0 prefix-cached blocks, oldest first (eviction order)
        self._cached: collections.OrderedDict[int, None] = \
            collections.OrderedDict()
        self._meta: list[_SlotMeta | None] = [None] * slots
        self._device_table: torch.Tensor | None = None
        self.stats = {
            "allocated_blocks": 0,    # fresh allocations (incl. CoW copies)
            "freed_blocks": 0,        # returned to the free list
            "evicted_blocks": 0,      # cached prefix blocks reclaimed
            "shared_blocks": 0,       # attached by reference at admission
            "shared_tokens": 0,       # prompt tokens skipped via sharing
            "cow_copies": 0,
            "swapped_out_blocks": 0,  # preemption: pages moved to scratch
            "swapped_in_blocks": 0,   # resume: pages restored from scratch
            "imported_blocks": 0,     # prefix blocks migrated in (router)
        }

    # -- content addressing --------------------------------------------------

    def _chain_keys(self, prompt, n_blocks: int) -> list[bytes]:
        """``keys[i]`` hashes the whole prefix ``prompt[:(i+1)*bs]`` —
        chain hashes are cumulative, so equal keys imply equal full token
        prefixes. Computed incrementally (one running sha1 updated block
        by block), so all keys cost one O(len) pass, not O(len^2)."""
        arr = np.ascontiguousarray(np.asarray(prompt, np.int64))
        h = hashlib.sha1()
        keys = []
        bs = self.block_size
        for i in range(n_blocks):
            h.update(arr[i * bs:(i + 1) * bs].tobytes())
            keys.append(h.digest())
        return keys

    def lookup_prefix(self, prompt) -> int:
        """Prompt tokens covered by cached full blocks (longest chain hit,
        capped so at least the final prompt token is always replayed —
        decode needs its logits, which are not cached)."""
        bs = self.block_size
        usable = min((len(prompt) - 1) // bs, self.max_blocks)
        n = 0
        for i, key in enumerate(self._chain_keys(prompt, usable)):
            if key not in self._prefix:
                break
            n = i + 1
        return n * bs

    # -- slot lifecycle ------------------------------------------------------

    def alloc_slot(self, slot: int, prompt) -> int:
        """Admit a request into ``slot``: attach every cached full prefix
        block by reference and return the number of prompt tokens those
        blocks cover (the engine starts replay/positions there). Never
        allocates — tail blocks are allocated on demand by ``ensure``."""
        if self._meta[slot] is not None:
            raise RuntimeError(f"slot {slot} is already allocated")
        bs = self.block_size
        full = min(len(prompt) // bs, self.max_blocks)
        keys = self._chain_keys(prompt, full)
        self._meta[slot] = _SlotMeta(chain_keys=keys, prompt_blocks=full)
        shared = 0
        usable = min((len(prompt) - 1) // bs, self.max_blocks)
        for i in range(usable):
            bid = self._prefix.get(keys[i])
            if bid is None:
                break
            self.table[slot, i] = bid
            self._retain(bid)
            shared = (i + 1) * bs
        if shared:
            self.stats["shared_blocks"] += shared // bs
            self.stats["shared_tokens"] += shared
            self._device_table = None
        return shared

    def free_slot(self, slot: int) -> None:
        """Release every block the slot references; blocks that back a
        cached prefix stay resident (evictable), the rest return to the
        free list."""
        for bi in range(self.max_blocks):
            bid = int(self.table[slot, bi])
            if bid >= 0:
                self._release(bid)
        self.table[slot, :] = -1
        self._meta[slot] = None
        self._device_table = None

    def fork_slot(self, src: int, dst: int) -> None:
        """Share ``src``'s entire table with ``dst`` (beam/n-best style).
        Both slots may keep decoding: the first write into any now-shared
        block triggers the copy-on-write in ``ensure``."""
        if self._meta[dst] is not None:
            raise RuntimeError(f"slot {dst} is already allocated")
        src_meta = self._meta[src]
        if src_meta is None:
            raise RuntimeError(f"slot {src} is not allocated")
        for bi in range(self.max_blocks):
            bid = int(self.table[src, bi])
            if bid >= 0:
                self.table[dst, bi] = bid
                self._retain(bid)
        self._meta[dst] = _SlotMeta(chain_keys=list(src_meta.chain_keys),
                                    prompt_blocks=src_meta.prompt_blocks)
        self._device_table = None

    # -- admission accounting ------------------------------------------------

    @property
    def allocatable_blocks(self) -> int:
        """Pool capacity available to slots (scratch block excluded)."""
        return self.num_blocks - 1

    @property
    def available_blocks(self) -> int:
        """Blocks an allocation could obtain right now: the free list
        plus the evictable (ref-0) cached prefix blocks."""
        return len(self._free) + len(self._cached)

    def total_blocks_for(self, prompt_len: int, max_tokens: int) -> int:
        """Blocks a request references at peak (shared prefix included)."""
        return math.ceil((prompt_len + max_tokens) / self.block_size)

    def blocks_needed(self, prompt, max_tokens: int) -> int:
        """Pool capacity admitting this request would consume out of
        ``available_blocks``: its peak footprint minus the cached prefix
        blocks it can attach **that are live elsewhere** (ref > 0 — those
        cost nothing). An evictable ref-0 cached block saves the replay
        compute but still spends one unit of availability when attached
        (it leaves the evictable pool), so it counts as needed — treating
        it as free double-counts it and over-admits into an OOM."""
        total = self.total_blocks_for(len(prompt), max_tokens)
        usable = min((len(prompt) - 1) // self.block_size, self.max_blocks)
        live_shared = 0
        for key in self._chain_keys(prompt, usable):
            bid = self._prefix.get(key)
            if bid is None:
                break
            if self.ref[bid] > 0:
                live_shared += 1
        return max(0, total - live_shared)

    # -- preemption: page swap-out / swap-in ---------------------------------

    def swap_out(self, cache, slot: int) -> SwappedPages:
        """Copy every block the slot references to host scratch, then
        free the slot — the pages leave the pool, the content survives.
        ``cache`` is read, never written (the blocks are simply
        reclaimable afterwards)."""
        if self._meta[slot] is None:
            raise RuntimeError(f"slot {slot} is not allocated")
        pages: list[tuple[int, object]] = []
        for bi in range(self.max_blocks):
            bid = int(self.table[slot, bi])
            if bid >= 0:
                content = _tree_map(_host_copy(bid), cache)
                pages.append((bi, content))
        self.free_slot(slot)
        self.stats["swapped_out_blocks"] += len(pages)
        return SwappedPages(pages=pages)

    def swap_in(self, cache, slot: int, prompt, swapped: SwappedPages):
        """Re-admit a preempted request: attach any prefix blocks still
        cached by reference (same as a fresh admission), then restore the
        remaining pages from scratch into fresh blocks. Returns
        ``(cache, shared_tokens)`` — the block content is restored
        bit-exactly, so decode resumes token-identical to an uninterrupted
        run."""
        shared = self.alloc_slot(slot, prompt)
        covered = shared // self.block_size
        restored = 0
        for bi, content in swapped.pages:
            if bi < covered:
                continue            # immutable full prompt block, re-attached
            new = self._get_free_block()
            self.table[slot, bi] = new
            self.ref[new] = 1
            _tree_map(lambda a, c: a[:, new].copy_(c), cache, content)
            restored += 1
        if restored:
            self.stats["allocated_blocks"] += restored
            self.stats["swapped_in_blocks"] += restored
            self._device_table = None
        return cache, shared

    # -- cross-engine prefix migration ---------------------------------------

    def export_prefix(self, cache, prompt):
        """Host-side copy of the cached full-prefix chain covering
        ``prompt`` (longest hit, same cap as :meth:`lookup_prefix`).
        Returns ``(tokens_covered, pages)`` where ``pages`` is one host
        tensor tree per chain block, in chain order."""
        bs = self.block_size
        usable = min((len(prompt) - 1) // bs, self.max_blocks)
        pages = []
        for key in self._chain_keys(prompt, usable):
            bid = self._prefix.get(key)
            if bid is None:
                break
            pages.append(_tree_map(_host_copy(bid), cache))
        return len(pages) * bs, pages

    def import_prefix(self, cache, prompt, pages):
        """Install an exported prefix chain into this pool: each block
        lands in a fresh physical block, registered in the prefix index
        as an evictable ref-0 cached block (exactly the state a locally
        computed prefix block reaches once its last referent drains).
        Chain blocks this pool already caches are skipped. Returns the
        storage (written in place)."""
        keys = self._chain_keys(prompt, len(pages))
        imported = 0
        for key, content in zip(keys, pages):
            if key in self._prefix:
                continue
            new = self._get_free_block()
            _tree_map(lambda a, c: a[:, new].copy_(c), cache, content)
            self.ref[new] = 0
            self._prefix[key] = new
            self._block_key[new] = key
            self._cached[new] = None
            self._cached.move_to_end(new)
            imported += 1
        if imported:
            self.stats["imported_blocks"] += imported
        return cache

    # -- write-path maintenance ----------------------------------------------

    def ensure(self, cache, slot: int, pos: int):
        """Make position ``pos`` of ``slot`` writable before the decode
        tick: allocate the covering block if absent, or — when the block
        is shared (refcount > 1) — copy it to a private block first
        (copy-on-write). Returns the storage (written in place)."""
        bi = pos // self.block_size
        if bi >= self.max_blocks:
            raise KVCacheOOM(
                f"slot {slot} position {pos} exceeds the per-slot table "
                f"({self.max_blocks} blocks x {self.block_size} tokens = "
                f"max_len {self.max_len}); raise max_len")
        bid = int(self.table[slot, bi])
        if bid < 0:
            new = self._get_free_block()
            self.table[slot, bi] = new
            self.ref[new] = 1
            self.stats["allocated_blocks"] += 1
            self._device_table = None
        elif self.ref[bid] > 1:
            new = self._get_free_block()
            cache = copy_block(cache, bid, new)
            self._release(bid)
            self.table[slot, bi] = new
            self.ref[new] = 1
            self.stats["cow_copies"] += 1
            self.stats["allocated_blocks"] += 1
            self._device_table = None
        return cache

    def note_filled(self, slot: int, pos: int) -> None:
        """Record that ``pos`` was written. When that completes a block
        holding only prompt tokens, register it in the prefix index so
        later requests sharing the prefix attach it instead of
        recomputing."""
        if (pos + 1) % self.block_size:
            return
        bi = pos // self.block_size
        meta = self._meta[slot]
        if meta is None or bi >= meta.prompt_blocks:
            return                     # tail / generated block: private
        key = meta.chain_keys[bi]
        bid = int(self.table[slot, bi])
        if key not in self._prefix and bid not in self._block_key:
            self._prefix[key] = bid
            self._block_key[bid] = key

    # -- device views --------------------------------------------------------

    def device_table(self) -> torch.Tensor:
        """Clamped int32 ``[slots, max_blocks]`` table on the allocator's
        device for the gather path and the kernel (unallocated entries
        point at the scratch block; reads from it are masked by the
        position bound). Uploaded again only after the table changed."""
        if self._device_table is None:
            self._device_table = torch.from_numpy(
                np.maximum(self.table, SCRATCH_BLOCK)).to(self.device)
        return self._device_table

    # -- pool internals ------------------------------------------------------

    def _retain(self, bid: int) -> None:
        if self.ref[bid] == 0:
            self._cached.pop(bid, None)    # was evictable; now live again
        self.ref[bid] += 1

    def _release(self, bid: int) -> None:
        self.ref[bid] -= 1
        assert self.ref[bid] >= 0, f"refcount underflow on block {bid}"
        if self.ref[bid] == 0:
            if bid in self._block_key:
                self._cached[bid] = None   # keep cached, evictable LRU
                self._cached.move_to_end(bid)
            else:
                self._free.append(bid)
                self.stats["freed_blocks"] += 1

    def _get_free_block(self) -> int:
        if self._free:
            return self._free.popleft()
        if self._cached:
            bid, _ = self._cached.popitem(last=False)   # LRU prefix block
            key = self._block_key.pop(bid)
            del self._prefix[key]
            self.stats["evicted_blocks"] += 1
            obs.metrics().counter("serve.kv_evictions").inc()
            tr = obs.tracer()
            if tr.enabled:
                tr.instant("evict", lane="serve", block=bid)
            return bid
        raise KVCacheOOM(
            f"paged KV pool exhausted: all {self.num_blocks - 1} "
            f"allocatable blocks (block_size {self.block_size}) are "
            f"referenced by live slots; raise kv_blocks or drain requests")

    @property
    def live_blocks(self) -> int:
        """Blocks currently referenced by at least one slot (scratch
        excluded)."""
        return int((self.ref[1:] > 0).sum())

    @property
    def cached_blocks(self) -> int:
        """Unreferenced blocks kept resident for prefix reuse."""
        return len(self._cached)

    @property
    def free_blocks(self) -> int:
        return len(self._free)


def copy_block(cache, src: int, dst: int):
    """Device-side block copy across every storage leaf, in place (the
    reference returns an updated copy). Leaves are ``[n_layers,
    num_blocks, block_size, n_kv, head_dim]`` — the block axis is 1 (the
    model stacks attention sites on axis 0). Returns ``cache``."""
    _tree_map(lambda a: a[:, dst].copy_(a[:, src]), cache)
    return cache
