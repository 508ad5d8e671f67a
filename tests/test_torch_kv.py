"""The port's ``PagedKVCache`` against the reference's, driven through the
same operations: alloc, ensure, fork (copy-on-write), free, prefix hits,
eviction, swap out/in and prefix export/import. Tables, refcounts, free
and cached lists and ``stats`` must be equal after every step, and the
block contents (written in place by the port, copied by the reference)
bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import kv as ref_kv
from repro_torch.serve import kv

N_BLOCKS, BS, SLOTS, MAX_LEN = 10, 4, 3, 24


def _same_pages(port_pages, ref_pages):
    """Host copies of blocks: the port's tensors equal the reference's
    arrays bit for bit."""
    assert len(port_pages) == len(ref_pages)
    for pp, rp in zip(port_pages, ref_pages):
        if isinstance(pp, tuple):            # (table index, tree)
            assert pp[0] == rp[0]
            pp, rp = pp[1], rp[1]
        assert np.array_equal(pp["k"].numpy(), np.asarray(rp["k"]))


class Pair:
    """One allocator of each package over equal stores, stepped together.
    Every operation must raise ``KVCacheOOM`` on both sides or on
    neither."""

    def __init__(self):
        self.port = kv.PagedKVCache(N_BLOCKS, BS, SLOTS, MAX_LEN,
                                    device="cpu")
        self.ref = ref_kv.PagedKVCache(N_BLOCKS, BS, SLOTS, MAX_LEN)
        init = np.arange(2 * N_BLOCKS * BS, dtype=np.float32).reshape(
            2, N_BLOCKS, BS)
        self.ps = {"k": torch.from_numpy(init.copy())}
        self.rs = {"k": jnp.asarray(init)}
        self.value = 1000.0

    def check(self):
        p, r = self.port, self.ref
        assert np.array_equal(p.table, r.table)
        assert np.array_equal(p.ref, r.ref)
        assert p.stats == r.stats
        assert list(p._free) == list(r._free)
        assert list(p._cached) == list(r._cached)
        assert p._prefix == r._prefix
        assert np.array_equal(p.device_table().numpy(),
                              np.asarray(r.device_table()))
        assert np.array_equal(self.ps["k"].numpy(), np.asarray(self.rs["k"]))

    def _both(self, port_call, ref_call):
        results = []
        for call, oom in ((port_call, kv.KVCacheOOM),
                          (ref_call, ref_kv.KVCacheOOM)):
            try:
                results.append(call())
            except oom:
                results.append(oom)
        raised = [r is kv.KVCacheOOM or r is ref_kv.KVCacheOOM
                  for r in results]
        assert raised[0] == raised[1], results
        return None if raised[0] else results

    def meta(self, name, *args):
        """A host-only method (no store), on both sides."""
        return self._both(lambda: getattr(self.port, name)(*args),
                          lambda: getattr(self.ref, name)(*args))

    def ensure(self, slot, pos) -> bool:
        out = self._both(lambda: self.port.ensure(self.ps, slot, pos),
                         lambda: self.ref.ensure(self.rs, slot, pos))
        if out is not None:
            self.ps, self.rs = out
        return out is not None

    def write(self, slot, pos):
        """A decode write of a fresh value at ``pos`` of ``slot``."""
        self.value += 1
        blk, off = int(self.port.table[slot, pos // BS]), pos % BS
        self.ps["k"][0, blk, off] = self.value
        self.rs = {"k": self.rs["k"].at[0, blk, off].set(self.value)}

    def fill(self, slot, start, stop) -> bool:
        """ensure + write + note_filled for positions [start, stop)."""
        for pos in range(start, stop):
            if not self.ensure(slot, pos):
                return False
            self.write(slot, pos)
            self.meta("note_filled", slot, pos)
        return True

    def swap_out(self, slot):
        pp, rp = self._both(lambda: self.port.swap_out(self.ps, slot),
                            lambda: self.ref.swap_out(self.rs, slot))
        _same_pages(pp.pages, rp.pages)
        return pp, rp

    def swap_in(self, slot, prompt, pages) -> int | None:
        out = self._both(
            lambda: self.port.swap_in(self.ps, slot, prompt, pages[0]),
            lambda: self.ref.swap_in(self.rs, slot, prompt, pages[1]))
        if out is None:
            return None
        (self.ps, shared), (self.rs, ref_shared) = out
        assert shared == ref_shared
        return shared


def test_scripted_lifecycle_matches_reference():
    pair = Pair()
    prompt = np.arange(9, dtype=np.int32)
    assert pair.meta("alloc_slot", 0, prompt) == [0, 0]
    assert pair.fill(0, 0, 9)
    pair.check()
    pair.meta("fork_slot", 0, 1)                      # share every block
    pair.check()
    assert pair.fill(1, 9, 10)                        # CoW of the tail
    assert pair.port.stats["cow_copies"] == 1
    pair.check()
    pair.meta("free_slot", 0)
    pair.check()
    hit = pair.meta("alloc_slot", 2,
                    np.concatenate([prompt[:8], [4, 3, 2]]))
    assert hit == [8, 8]                              # prefix hit
    pair.check()
    pages = pair.swap_out(1)                          # pages bit-exact
    pair.check()
    assert pair.swap_in(0, prompt, pages) == 8
    assert pair.port.stats["swapped_in_blocks"] == 1
    pair.check()
    # export the cached chain, import it into a fresh pair of pools
    (pc, pe), (rc, re_) = pair._both(
        lambda: pair.port.export_prefix(pair.ps, prompt),
        lambda: pair.ref.export_prefix(pair.rs, prompt))
    assert pc == rc == 8
    _same_pages(pe, re_)
    other = Pair()
    other.ps = other.port.import_prefix(other.ps, prompt, pe)
    other.rs = other.ref.import_prefix(other.rs, prompt, re_)
    other.check()
    assert other.port.lookup_prefix(prompt) == 8
    assert other.port.stats["imported_blocks"] == 2
    assert other.port.cached_blocks == 2


def test_eviction_of_cached_prefix_blocks_matches_reference():
    pair = Pair()
    for slot in range(2):                 # two cached 2-block prefixes
        p = np.arange(9, dtype=np.int32) + 10 * slot
        pair.meta("alloc_slot", slot, p)
        assert pair.fill(slot, 0, 8)
        pair.meta("free_slot", slot)
    assert pair.port.cached_blocks == 4
    pair.check()
    pair.meta("alloc_slot", 0, np.arange(30, 60, dtype=np.int32))
    assert pair.fill(0, 0, MAX_LEN)       # needs 6 blocks: evicts LRU
    assert pair.port.stats["evicted_blocks"] > 0
    pair.check()
    pair.meta("alloc_slot", 1, np.arange(60, 80, dtype=np.int32))
    assert not pair.fill(1, 0, 16)        # 4 blocks, 3 left: OOM on both
    pair.check()


@pytest.mark.parametrize("seed", range(4))
def test_random_operation_sequences_match_reference(seed):
    """Random alloc / decode / fork / free / swap traffic over a small pool
    (prompts share prefixes, so hits, CoW and evictions all occur)."""
    rng = np.random.default_rng(seed)
    pair = Pair()
    bases = [rng.integers(0, 5, 12).astype(np.int32) for _ in range(2)]
    pos = [0] * SLOTS
    prompts: list = [None] * SLOTS
    swapped = []                       # (prompt, pos, (port, ref) pages)
    ops = ("alloc", "decode", "decode", "fork", "free", "swap_out",
           "swap_in")
    for _ in range(60):
        live = [s for s in range(SLOTS) if prompts[s] is not None]
        free = [s for s in range(SLOTS) if prompts[s] is None]
        op = ops[int(rng.integers(len(ops)))]
        if op == "alloc" and free:
            s = int(rng.choice(free))
            base = bases[int(rng.integers(2))]
            p = np.concatenate([base[:int(rng.integers(2, 12))],
                                rng.integers(0, 5, int(rng.integers(0, 4)))
                                ]).astype(np.int32)
            shared, ref_shared = pair.meta("alloc_slot", s, p)
            assert shared == ref_shared
            prompts[s] = p
            if pair.fill(s, shared, len(p) - 1):
                pos[s] = len(p) - 1
            else:
                pair.meta("free_slot", s)
                prompts[s] = None
        elif op == "decode" and live:
            s = int(rng.choice(live))
            if pos[s] < MAX_LEN and pair.fill(s, pos[s], pos[s] + 1):
                pos[s] += 1
        elif op == "fork" and live and free:
            src, dst = int(rng.choice(live)), int(rng.choice(free))
            pair.meta("fork_slot", src, dst)
            prompts[dst], pos[dst] = prompts[src], pos[src]
        elif op == "free" and live:
            s = int(rng.choice(live))
            pair.meta("free_slot", s)
            prompts[s] = None
        elif op == "swap_out" and live:
            s = int(rng.choice(live))
            swapped.append((prompts[s], pos[s], pair.swap_out(s)))
            prompts[s] = None
        elif op == "swap_in" and swapped and free:
            s = int(rng.choice(free))
            p, at, pages = swapped.pop()
            if pair.swap_in(s, p, pages) is None:
                pair.meta("free_slot", s)     # pool dry mid-restore
            else:
                prompts[s], pos[s] = p, at
        pair.check()


def test_token_sizes_match_reference():
    assert kv.kv_token_bits(8, 128) == ref_kv.kv_token_bits(8, 128)
    assert (kv.kv_token_bytes(8, 128, 32)
            == ref_kv.kv_token_bytes(8, 128, 32))
    for kv_dtype in ("fp32", "fp16", "int8", "fp8_e4m3", "fp8_e5m2", "fp8"):
        assert (kv.kv_token_bits(8, 128, kv_dtype)
                == ref_kv.kv_token_bits(8, 128, kv_dtype))
        assert (kv.kv_token_bytes(8, 128, 32, kv_dtype)
                == ref_kv.kv_token_bytes(8, 128, 32, kv_dtype))
