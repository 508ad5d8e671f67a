"""Batched serving engine over a paged KV pool: the port of
``repro.serve.engine`` on its paged path.

A fixed pool of B slots shares one decode step. Requests are admitted
into free slots, decode ticks advance every active slot by one token, and
finished slots (EOS or max_tokens) are refilled from the queue in the same
tick (continuous batching). KV lives in a shared block pool
(``repro_torch.serve.kv.PagedKVCache``); slots hold block tables and
per-slot positions, so recycled slots restart at position 0 with fresh
blocks, and requests whose prompts extend a cached prefix skip the shared
full blocks. When a tick cannot allocate a block, the lowest-priority,
youngest slot is swapped out to host memory and resumed later,
token-identically.

The engine can be driven whole (``run``) or tick by tick
(``tick_once``). ``run``'s default tick budget is the total remaining
work (unreplayed prompt plus ungenerated tokens).

Not ported yet — each raises ``NotImplementedError`` naming its item of
the port queue in ``ROADMAP.md``: the contiguous lanes (``paged=False``),
the PIM backend and its partitions, weight/activation/KV quantization,
``kv_dequant_errors`` and ``drift_report``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve.kv import KVCacheOOM, PagedKVCache

_PIM = "ROADMAP.md, port queue item 3: the mapper and the PIM backend"
_QUANT_KV = "ROADMAP.md, port queue item 2: quantized KV serving"
_CONTIGUOUS = ("ROADMAP.md, port queue item 6: contiguous lanes, router, "
               "workload")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [L] int32
    max_tokens: int = 16
    eos: int | None = None
    # SLO class: preemption victims are picked from the *lowest* class
    # first (youngest admission within a class); the default 0 for every
    # request preserves plain youngest-first
    priority: int = 0
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # wall-clock stamps (time.monotonic): submit / first generated token /
    # completion — the raw material of the TTFT/TPOT histograms
    t_submit: float | None = None
    t_first: float | None = None
    t_done: float | None = None
    # preemption: bumped per swap-out; ``resume`` holds the engine's saved
    # decode state + scratch pages between swap-out and re-admission
    preemptions: int = 0
    resume: dict | None = dataclasses.field(default=None, repr=False)

    @property
    def ttft_s(self) -> float | None:
        """Time to first token (None until one is generated)."""
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def tpot_s(self) -> float | None:
        """Mean time per output token after the first (needs >= 2)."""
        if self.t_first is None or self.t_done is None or len(self.out) < 2:
            return None
        return (self.t_done - self.t_first) / (len(self.out) - 1)


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: DecoderLM, *, batch: int = 4,
                 max_len: int = 128, sample: Callable | None = None,
                 backend: str = "jit", weight_dtype: str = "fp32",
                 partitions: int = 1, paged: bool = False,
                 kv_blocks: int | None = None, kv_block_size: int = 16,
                 prefill: str = "replay", attn_kernel: bool = False,
                 scheduler: str = "continuous",
                 admission: str = "kv", preempt: bool = True,
                 kv_dtype: str = "fp32", act_dtype: str = "fp32",
                 device: str | torch.device | None = None):
        """``params`` is the model (a ``DecoderLM`` on ``device``).
        ``device`` defaults to CUDA; pass ``device="cpu"`` for the plain
        PyTorch path. The options keep the reference's names, defaults
        and meanings; ``backend="jit"`` is the reference's name for the
        direct (non-PIM) decode path, which the port runs eagerly.

        ``paged=True`` is required: KV lives in ``kv_blocks`` physical
        blocks of ``kv_block_size`` tokens (default: scratch + ``batch *
        ceil(max_len / kv_block_size)``). ``prefill="batch"`` writes a
        prompt's KV blocks in one call per admission instead of replaying
        it token by token; the decode tick that feeds the final prompt
        token is unchanged. ``attn_kernel=True`` runs every decode site's
        attention through the paged decode kernel (on CUDA, the
        hand-written kernel: one launch per layer per tick for all slots).

        ``sample`` maps the logits ``[B, V]`` to token ids ``[B]`` (greedy
        argmax by default).

        ``scheduler="continuous"`` refills a finished slot the same tick;
        ``"static"`` admits a full batch and drains it first.
        ``admission="kv"`` (default) admits the queue head only when the
        pool's free + evictable blocks cover its peak footprint; ``"slot"``
        admits into any free slot. ``preempt=True`` swaps the youngest,
        lowest-priority slot out to host memory when a tick cannot
        allocate a block."""
        unported = []
        if backend == "pim" or partitions > 1:
            unported.append(f"backend='pim' / partitions ({_PIM})")
        if weight_dtype != "fp32" or act_dtype != "fp32":
            unported.append(f"weight_dtype / act_dtype ({_PIM})")
        if kv_dtype != "fp32":
            unported.append(f"kv_dtype={kv_dtype!r} ({_QUANT_KV})")
        if not paged:
            unported.append(f"paged=False, the contiguous lanes "
                            f"({_CONTIGUOUS})")
        if unported:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(unported))
        if backend != "jit":
            raise ValueError(f"backend must be 'jit' or 'pim', "
                             f"got {backend!r}")
        if partitions < 1:
            raise ValueError("partitions must be >= 1")
        if prefill not in ("replay", "batch"):
            raise ValueError(f"prefill must be 'replay' or 'batch', "
                             f"got {prefill!r}")
        if scheduler not in ("continuous", "static"):
            raise ValueError(f"scheduler must be 'continuous' or "
                             f"'static', got {scheduler!r}")
        if admission not in ("kv", "slot"):
            raise ValueError(f"admission must be 'kv' or 'slot', "
                             f"got {admission!r}")
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"the model is on {params.device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.model = params
        self.batch = batch
        self.max_len = max_len
        self.slots: list[Request | None] = [None] * batch
        self.queue: deque[Request] = deque()
        self.sample = sample or (lambda logits: torch.argmax(logits, -1))
        self.scheduler = scheduler
        self.admission = admission
        self.preempt = bool(preempt)
        self.preemptions = 0
        self.resumes = 0
        self.swapped_blocks = 0   # pages currently on host scratch
        self.prefill = prefill
        self.attn_kernel = attn_kernel
        self.prefill_batched_tokens = 0

        self.block_size = kv_block_size
        self.max_blocks = math.ceil(max_len / kv_block_size)
        if kv_blocks is None:
            kv_blocks = 1 + batch * self.max_blocks
        self.kv = PagedKVCache(kv_blocks, kv_block_size, batch, max_len,
                               device=self.device)
        self.cache = self.model.init_paged_cache(kv_blocks, kv_block_size)

        # per-token KV footprint (bytes, all attention sites) for the
        # bytes-moved accounting
        self._tok_bytes = (cfg.n_layers * 2 * cfg.n_kv_heads
                           * cfg.resolved_head_dim
                           * self.model.dtype.itemsize)
        self.kv_bytes_read = 0
        self.kv_bytes_written = 0
        self.prefix_skipped_tokens = 0

        self.completed: list[Request] = []
        self.starved: list[int] = []        # rids pending at last run() exit
        # per-slot decode state (persistent so tick_once can be driven
        # externally)
        self._prompt_idx = np.zeros(batch, np.int64)
        self._last_tok = np.zeros(batch, np.int32)
        self._pos = np.zeros(batch, np.int32)    # per-slot position
        self._tick = 0
        # admission order per slot (monotone): the preemption victim is
        # the youngest-admitted active slot — deterministic, and older
        # requests are never starved by later arrivals
        self._adm_seq = np.full(batch, -1, np.int64)
        self._adm_counter = 0
        # incrementally maintained total remaining work (see
        # ``pending_work``): O(1) per tick instead of O(queue)
        self._work = 0

    def _decode(self, tokens: np.ndarray) -> torch.Tensor:
        logits, self.cache = self.model.decode_step_paged(
            self.cache, torch.from_numpy(tokens).to(self.device),
            self.kv.device_table(), torch.from_numpy(self._pos).to(
                self.device), kernel=self.attn_kernel)
        return logits

    def submit(self, req: Request) -> None:
        if req.t_submit is None:
            req.t_submit = time.monotonic()
        obs.metrics().counter("serve.submitted").inc()
        self._work += self._work_of(req)
        self.queue.append(req)

    def kv_blocks_needed(self, req: Request) -> int:
        """Fresh blocks admitting ``req`` here would eventually allocate."""
        return self.kv.blocks_needed(req.prompt, req.max_tokens)

    @staticmethod
    def _work_of(req: Request) -> int:
        """Decode ticks this request still needs: unreplayed prompt
        tokens (resume state included) plus ungenerated tokens."""
        k = req.resume["prompt_idx"] if req.resume is not None else 0
        return (max(0, len(req.prompt) - 1 - k)
                + req.max_tokens - len(req.out))

    def pending_work(self) -> int:
        """Upper bound on the decode ticks needed to drain queue + slots:
        unreplayed prompt tokens plus ungenerated tokens. Maintained
        incrementally (O(1) per tick/submit)."""
        return self._work

    def _pending_work_recompute(self) -> int:
        """O(queue + slots) reference for the incremental counter."""
        w = sum(self._work_of(r) for r in self.queue)
        for s, r in enumerate(self.slots):
            if r is not None:
                w += (max(0, len(r.prompt) - 1 - int(self._prompt_idx[s]))
                      + r.max_tokens - len(r.out))
        return w

    def pending_rids(self) -> list[int]:
        return ([r.rid for r in self.slots if r is not None]
                + [r.rid for r in self.queue])

    def _admissible(self, req: Request) -> bool:
        """KV-aware admission gate: admit only when the pool can cover
        the request's peak fresh-block footprint, keeping one spare block
        per already-active slot so imminent growth doesn't immediately
        preempt the admission (anti-thrash headroom)."""
        total = self.kv.total_blocks_for(len(req.prompt), req.max_tokens)
        if total > self.kv.allocatable_blocks:
            raise KVCacheOOM(
                f"request rid={req.rid} needs {total} KV blocks at peak "
                f"(prompt {len(req.prompt)} + max_tokens "
                f"{req.max_tokens}, block_size {self.block_size}) but the "
                f"pool only has {self.kv.allocatable_blocks} allocatable "
                f"blocks; raise kv_blocks or shrink the request")
        if total > self.kv.max_blocks:
            raise KVCacheOOM(
                f"request rid={req.rid} needs {total} KV blocks at peak "
                f"(prompt {len(req.prompt)} + max_tokens "
                f"{req.max_tokens}) but a slot's table holds only "
                f"{self.kv.max_blocks} blocks (max_len {self.max_len}); "
                f"raise max_len or shrink the request")
        reserve = sum(1 for r in self.slots if r is not None)
        needed = self.kv_blocks_needed(req)
        return self.kv.available_blocks >= needed + reserve

    def _admit(self) -> None:
        if self.scheduler == "static" and any(
                r is not None for r in self.slots):
            return          # wave batching: drain the batch first
        for s in range(self.batch):
            if self.slots[s] is None and self.queue:
                req = self.queue[0]
                if self.admission == "kv" and not self._admissible(req):
                    break   # FIFO: the head waits, nothing overtakes it
                self.queue.popleft()
                self.slots[s] = req
                self._adm_seq[s] = self._adm_counter
                self._adm_counter += 1
                obs.metrics().counter("serve.admitted").inc()
                tr = obs.tracer()
                if tr.enabled:
                    tr.instant("admit", lane="serve", rid=req.rid, slot=s)
                # explicit per-slot state reset on (re)admission — a
                # recycled slot must never rely on the prompt phase
                # masking the previous occupant's sample/cursor
                self._prompt_idx[s] = 0
                self._last_tok[s] = 0
                if req.resume is not None:
                    self._resume_slot(s, req)
                else:
                    shared = self.kv.alloc_slot(s, req.prompt)
                    self._pos[s] = shared
                    self._prompt_idx[s] = shared   # skip cached prefix
                    self.prefix_skipped_tokens += shared
                    self._work -= shared
                    if self.prefill == "batch":
                        self._prefill_slot(s, req, shared)

    def _resume_slot(self, s: int, req: Request) -> None:
        """Re-admit a preempted request: migrate its scratch pages back
        into the pool and restore the saved decode cursor — the next tick
        continues exactly where the swap-out interrupted."""
        st = req.resume
        self.swapped_blocks -= st["pages"].n_blocks
        self.cache, _ = self.kv.swap_in(self.cache, s, req.prompt,
                                        st["pages"])
        self._pos[s] = st["pos"]
        self._prompt_idx[s] = st["prompt_idx"]
        self._last_tok[s] = st["last_tok"]
        req.resume = None
        self.resumes += 1
        obs.metrics().counter("serve.resumed").inc()
        tr = obs.tracer()
        if tr.enabled:
            tr.instant("resume", lane="serve", rid=req.rid, slot=s)

    def _preempt(self, s: int) -> None:
        """Swap the slot's KV pages out to host scratch, save its decode
        cursor on the request, and requeue it at the *front* — it resumes
        as soon as capacity frees, ahead of new arrivals."""
        req = self.slots[s]
        pages = self.kv.swap_out(self.cache, s)
        req.resume = dict(pages=pages, pos=int(self._pos[s]),
                          prompt_idx=int(self._prompt_idx[s]),
                          last_tok=int(self._last_tok[s]))
        req.preemptions += 1
        self.preemptions += 1
        self.swapped_blocks += pages.n_blocks
        obs.metrics().counter("serve.preempted").inc()
        tr = obs.tracer()
        if tr.enabled:
            tr.instant("preempt", lane="serve", rid=req.rid, slot=s,
                       blocks=pages.n_blocks)
        self.slots[s] = None
        self._adm_seq[s] = -1
        self._prompt_idx[s] = 0
        self._last_tok[s] = 0
        self._pos[s] = 0
        self.queue.appendleft(req)

    def _ensure_active(self, active: list[int]) -> list[int]:
        """Make every active slot's next position writable, swapping out
        victims when the pool runs dry: lowest ``priority`` class first,
        youngest admission within a class. Returns the surviving active
        slots. With ``preempt=False`` the allocator's ``KVCacheOOM``
        propagates."""
        # oldest admissions ensure first, so a same-class victim is
        # always younger than (or equal to) the slot that triggered the
        # shortfall
        for s in sorted(active, key=lambda s: self._adm_seq[s]):
            while self.slots[s] is not None:
                try:
                    self.cache = self.kv.ensure(self.cache, s,
                                                int(self._pos[s]))
                    break
                except KVCacheOOM:
                    if not self.preempt:
                        raise
                    victims = [v for v in range(self.batch)
                               if v != s and self.slots[v] is not None]
                    if not victims:
                        raise
                    self._preempt(max(
                        victims,
                        key=lambda v: (-self.slots[v].priority,
                                       self._adm_seq[v])))
        return [s for s in active if self.slots[s] is not None]

    def _prefill_slot(self, s: int, req: Request, p0: int) -> None:
        """Write the slot's uncached prompt KV (all but the final prompt
        token) into its blocks in one call. The next decode tick feeds the
        final prompt token exactly as the replay path would."""
        n_new = len(req.prompt) - 1 - p0
        if n_new < 1:
            return
        tr = obs.tracer()
        with obs.span("prefill:batch", lane="serve", rid=req.rid, slot=s,
                      tokens=n_new):
            self._prefill_slot_inner(s, req, p0, n_new)
            if tr.enabled and self.device.type == "cuda":
                # the span times the device work, not its enqueue
                torch.cuda.synchronize(self.device)
        obs.metrics().counter("serve.prefill_tokens").inc(n_new)

    def _prefill_slot_inner(self, s: int, req: Request, p0: int,
                            n_new: int) -> None:
        bs = self.block_size
        # p0 is block-aligned (admission attaches whole cached blocks),
        # so one ensure/note_filled per covered block suffices
        for pos in range(p0, p0 + n_new, bs):   # allocate covering blocks
            self.cache = self.kv.ensure(self.cache, s, pos)
        t_pad = -(-n_new // bs) * bs            # whole blocks, as reference
        toks = np.zeros(t_pad, np.int64)
        toks[:n_new] = req.prompt[p0:p0 + n_new]
        self.cache = self.model.prefill_paged(
            self.cache, torch.from_numpy(toks).to(self.device),
            self.kv.device_table()[s], p0, n_new)
        for pos in range(p0 + bs - 1, p0 + n_new, bs):
            self.kv.note_filled(s, pos)         # register full prompt blocks
        self._pos[s] = p0 + n_new
        self._prompt_idx[s] = len(req.prompt) - 1
        self._work -= n_new          # prompt positions consumed tick-free
        self.prefill_batched_tokens += n_new
        self.kv_bytes_written += n_new * self._tok_bytes
        # block-granular reads, closed form: sum over the n_new written
        # positions of ceil((p0+i+1)/bs)*bs — p0 is block-aligned, so the
        # per-position ceil term is p0 + ceil(t/bs)*bs for t = 1..n_new
        full, rem = divmod(n_new, bs)
        ceil_sum = bs * (full * (full + 1) // 2) + rem * (full + 1)
        self.kv_bytes_read += (n_new * p0 + bs * ceil_sum) * self._tok_bytes

    def _recycle(self, s: int) -> None:
        """Free the slot and explicitly reset all of its decode state."""
        self.slots[s] = None
        self._adm_seq[s] = -1
        self._prompt_idx[s] = 0
        self._last_tok[s] = 0
        self.kv.free_slot(s)
        self._pos[s] = 0

    def tick_once(self) -> bool:
        """Advance every active slot one token. Any slot that finishes is
        refilled from the queue *within this same tick* (see the trailing
        ``_admit``). Returns False when nothing is active."""
        self._admit()
        active = [s for s in range(self.batch) if self.slots[s] is not None]
        if not active:
            return False
        # writability first: this may preempt (swap out) victims, so the
        # feed is built only from the survivors
        active = self._ensure_active(active)
        feed = np.zeros(self.batch, np.int64)
        for s in active:
            req = self.slots[s]
            k = int(self._prompt_idx[s])
            feed[s] = (req.prompt[k] if k < len(req.prompt)
                       else self._last_tok[s])
        with obs.span("decode:tick", lane="serve", tick=self._tick,
                      active=len(active)):
            logits = self._decode(feed)
            # reading the ids back waits for the device, inside the span
            nxt = self.sample(logits).to("cpu", torch.int32).numpy()
        bs = self.block_size
        for s in active:
            self.kv.note_filled(s, int(self._pos[s]))
            self._pos[s] += 1
            # block-granular read + one-token write per site
            self.kv_bytes_read += (math.ceil(int(self._pos[s]) / bs)
                                   * bs * self._tok_bytes)
        self.kv_bytes_written += len(active) * self._tok_bytes
        for s in active:
            req = self.slots[s]
            self._work -= 1        # one prompt or output token per tick
            if self._prompt_idx[s] < len(req.prompt) - 1:
                self._prompt_idx[s] += 1
            else:
                self._prompt_idx[s] = len(req.prompt)  # gen: feed samples
                req.out.append(int(nxt[s]))
                self._last_tok[s] = nxt[s]
                if req.t_first is None:
                    req.t_first = time.monotonic()
                    if req.t_submit is not None:
                        obs.metrics().histogram("serve.ttft_s").observe(
                            req.t_first - req.t_submit)
                hit_eos = req.eos is not None and int(nxt[s]) == req.eos
                if len(req.out) >= req.max_tokens or hit_eos:
                    req.done = True
                    self._work -= req.max_tokens - len(req.out)  # early EOS
                    req.t_done = time.monotonic()
                    if req.tpot_s is not None:
                        obs.metrics().histogram("serve.tpot_s").observe(
                            req.tpot_s)
                    obs.metrics().counter("serve.completed").inc()
                    self.completed.append(req)
                    self._recycle(s)
        self._admit()
        self._tick += 1
        m = obs.metrics()
        m.counter("serve.ticks").inc()
        m.gauge("serve.queue_depth").set(len(self.queue))
        m.gauge("serve.kv_live_blocks").set(self.kv.live_blocks)
        m.gauge("serve.kv_cached_blocks").set(self.kv.cached_blocks)
        m.gauge("serve.kv_free_blocks").set(self.kv.free_blocks)
        m.gauge("serve.kv_swapped_blocks").set(self.swapped_blocks)
        return True

    def run(self, max_ticks: int | None = None, *,
            on_starvation: str = "raise") -> list[Request]:
        """Drive until queue + slots drain: all slots advance per tick; a
        slot in its prompt phase feeds its next prompt token, a slot in
        its generation phase its last sampled token; finished slots
        recycle.

        The tick budget defaults to the total remaining work. If it
        elapses with requests still pending, that is starvation:
        ``on_starvation="raise"`` (default) raises ``RuntimeError``;
        ``"return"`` records the pending request ids in ``self.starved``
        and returns what finished."""
        if on_starvation not in ("raise", "return"):
            raise ValueError(f"on_starvation must be 'raise' or 'return', "
                             f"got {on_starvation!r}")
        budget = max_ticks if max_ticks is not None \
            else max(1, self.pending_work())
        ticks = 0
        while ticks < budget and self.tick_once():
            ticks += 1
        self.starved = self.pending_rids()
        if self.starved and on_starvation == "raise":
            raise RuntimeError(
                f"serve loop stopped after {ticks} ticks (budget {budget}, "
                f"max_len {self.max_len}) with requests still pending "
                f"(rids {self.starved}); raise max_ticks/max_len or pass "
                f"on_starvation='return'")
        return self.completed

    def kv_dequant_errors(self, ref) -> np.ndarray:
        """Not ported yet: it measures a quantized pool's error."""
        raise NotImplementedError(f"kv_dequant_errors is not ported yet "
                                  f"({_QUANT_KV})")

    def drift_report(self, tracer=None):
        """Not ported yet: it joins spans against the PIM schedule."""
        raise NotImplementedError(f"drift_report is not ported yet ({_PIM})")
