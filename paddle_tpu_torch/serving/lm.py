"""Continuous-batching generative LM serving on the CUDA card.

The port of `paddle_tpu/serving/lm.py`. A generative request is a loop
— one prefill pass over the prompt, then one forward pass per generated
token — and `GenerationEngine` serves many at once by continuous
batching:

  * **KV cache** — paged by default: sequences hold growable page
    tables over a shared pool of `[L, P, n, page_len, D]` planes (page
    0 is the trash page dead writes land on), with a content-addressed
    prefix cache over page-aligned prompt prefixes and copy-on-write
    for a shared partial tail page. `paged=False` keeps the slab planes
    `[L, S, n, Tcap, D]`. The planes live on the device and are updated
    IN PLACE by the device functions (ops/transformer_ops.py) — the
    counterpart of the reference's buffer donation. The footprint is
    priced in closed form (weights + KV planes + per-step transients)
    against the card's free memory before anything is allocated: an
    engine that cannot fit refuses to construct.
  * **Prefill / decode phase split** — ragged prompts are padded up to
    (batch x prompt-length) bucket rungs and prefilled; the steady state
    is ONE fused greedy step over ALL slots, always at the full
    `[max_slots]` shape.
  * **Continuous admission** — new prompts are admitted into in-flight
    decode batches BETWEEN steps. Every per-row op touches only its own
    row and the decode shape never changes, so a request's tokens are
    the same whether it ran alone or co-batched.
  * **Streaming** — `submit()` returns a `GenerationStream`; tokens are
    pushed as they are decoded (serving/http.py chunks them over
    `POST /v1/generate`). Deadlines are enforced while queued AND
    between decode steps.

The host scheduler (`_loop`, `_admit_pages`, `_admit_and_prefill`,
`_decode_step`) is the reference's, nearly line for line. Telemetry
lands in the `serving_lm.*` registry family and the always-on `stats()`
dict (the /healthz payload).

The rungs — the decode step, each `prefill:{b}x{t}` and the page copy
(`GenerationConfig.rung_keys`) — are the reference's jit-compiled (or
AOT-baked) steps. On the card each is a CUDA graph (serving/graphs.py):
captured by `warmup()`, largest first, or at the rung's first dispatch,
and replayed in place of the eager step, under the dispatch lock;
`stats()` lists the captured keys in `aot_rungs` and reads
`aot_status` "cuda_graph". On the CPU the steps run eagerly and
`aot_status` is "none". The eager functions stay callable as
`_prefill_fn`, `_decode_fn` and `_copy_fn`.
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
import time

import numpy as np
import torch

from .. import flags, monitor
from .._device import resolve_device, use_full_f32
from ..ops import transformer_ops as T
from ..weights import lm_weights_from_numpy
from . import batching
from .graphs import StepGraphs
from .errors import (DeadlineExceededError, EngineClosedError,
                     ServerOverloadedError)

__all__ = ["LMSpec", "GenerationConfig", "GenerationStream",
           "GenerationEngine", "init_lm_weights", "price_kv_cache"]

# PyTorch's cuBLAS workspace per stream on sm_90 (CUBLAS_WORKSPACE_CONFIG
# unset: 4096 KiB x 8). The rungs' capture stream takes one at its
# first product: chip_smoke.py's engine phase reads 33,636,864 B live
# after warmup on an H100 (this and the rungs' static buffers).
_CUBLAS_WORKSPACE_BYTES = 4096 * 8 * 1024


def _finish(span, error=None):
    """Close a maybe-None span (span recording off => None everywhere).
    Span.finish is idempotent, so defensive double-closes are safe."""
    if span is not None:
        span.finish(error=error)


_STACK_LEAF_SHAPES = {
    "Ln1G": ("L", "H"), "Ln1B": ("L", "H"), "Wqkv": ("L", "H", "3H"),
    "Bqkv": ("L", "3H"), "Wproj": ("L", "H", "H"), "Bproj": ("L", "H"),
    "Ln2G": ("L", "H"), "Ln2B": ("L", "H"), "Wup": ("L", "H", "F"),
    "Bup": ("L", "F"), "Wdown": ("L", "F", "H"), "Bdown": ("L", "H"),
}


class LMSpec:
    """The generative-LM model contract: hyperparameters plus the
    weight-name/shape layout the stacked transformer_lm trains in
    either package (stacked
    `stack.<Leaf>` planes, head-major qkv columns — see
    ops/transformer_ops.py's layout docstring)."""

    __slots__ = ("vocab_size", "hidden_size", "num_layers", "num_heads",
                 "max_len", "ffn_hidden")

    def __init__(self, vocab_size, hidden_size, num_layers, num_heads,
                 max_len, ffn_hidden=None):
        self.vocab_size = int(vocab_size)
        self.hidden_size = int(hidden_size)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.max_len = int(max_len)
        self.ffn_hidden = int(ffn_hidden if ffn_hidden is not None
                              else 4 * self.hidden_size)
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} is not divisible by "
                f"num_heads {self.num_heads}")
        for k in self.__slots__:
            if getattr(self, k) < 1:
                raise ValueError(f"LMSpec.{k} must be >= 1")

    def weight_specs(self):
        """name -> shape tuple for every required weight (all f32)."""
        L, H, F, V = (self.num_layers, self.hidden_size,
                      self.ffn_hidden, self.vocab_size)
        dims = {"L": L, "H": H, "3H": 3 * H, "F": F}
        out = {f"stack.{leaf}": tuple(dims[d] for d in shape)
               for leaf, shape in _STACK_LEAF_SHAPES.items()}
        out.update({"tok_emb": (V, H), "pos_emb": (self.max_len, H),
                    "ln_f.w_0": (H,), "ln_f.w_1": (H,),
                    "lm_head.w": (H, V)})
        return out

    def validate_weights(self, weights):
        specs = self.weight_specs()
        missing = sorted(set(specs) - set(weights))
        if missing:
            raise ValueError(f"LM weights missing {missing} (spec "
                             "layout: see LMSpec.weight_specs)")
        for name, want in sorted(specs.items()):
            got = tuple(weights[name].shape)
            if got != want:
                raise ValueError(f"LM weight {name!r} has shape {got}, "
                                 f"spec wants {want}")

    def to_meta(self):
        return {k: getattr(self, k) for k in self.__slots__}

    @classmethod
    def from_meta(cls, d):
        return cls(**{k: d[k] for k in cls.__slots__})


def init_lm_weights(spec, seed=0, scale=0.02):
    """Random-normal f32 numpy weights matching `spec` (LN gains at 1),
    from a numpy seed — the same arrays the reference's factory makes
    for the same seed."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in spec.weight_specs().items():
        if name in ("ln_f.w_0",) or name.endswith((".Ln1G", ".Ln2G")):
            out[name] = np.ones(shape, np.float32)
        elif name == "ln_f.w_1" or name.endswith((".Ln1B", ".Ln2B")) \
                or ".B" in name:
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = (rng.randn(*shape) * scale).astype(np.float32)
    return out


def price_kv_cache(spec, config, itemsize=4):
    """Closed-form KV-plane bytes. Slab mode: K and V planes, each
    [L, max_slots, H, max_cache_len] elements. Paged mode: K and V
    page pools, each [L, num_pages + 1, H, page_len] elements (the +1
    is the reserved trash page dead writes land on)."""
    if getattr(config, "paged", False):
        return (2 * spec.num_layers * (config.num_pages + 1)
                * spec.hidden_size * config.page_len * itemsize)
    return (2 * spec.num_layers * config.max_slots * spec.hidden_size
            * config.max_cache_len * itemsize)


class _PagePool:
    """Host-side accounting for the paged KV planes: a free list over
    page ids 1..num_pages (page 0 is the reserved trash page), SPLIT
    reference counts — live page tables vs prefix-cache pins; a page
    returns to the free list only when both drop to zero — and a
    reservation ledger that makes admission deadlock-free: a request
    admits only once its WORST-CASE page count is set aside, so a
    decode step can never strand a live sequence waiting for a page.
    The alloc/free counters restate the slot-alloc == slot-free
    discipline at page granularity (a drained engine ends with
    page_allocs == page_frees). All mutation happens under the
    engine's condition lock."""

    __slots__ = ("num_pages", "free", "refs", "cache_refs", "reserved",
                 "allocs", "frees")

    def __init__(self, num_pages):
        self.num_pages = int(num_pages)
        # pop() hands out low page ids first (deterministic layouts)
        self.free = list(range(self.num_pages, 0, -1))
        self.refs = [0] * (self.num_pages + 1)
        self.cache_refs = [0] * (self.num_pages + 1)
        self.reserved = 0
        self.allocs = 0
        self.frees = 0

    def available(self):
        """Free pages an admission may still claim beyond the standing
        reservations of already-live sequences."""
        return len(self.free) - self.reserved

    def alloc(self):
        page = self.free.pop()
        self.refs[page] = 1
        self.allocs += 1
        return page

    def incref(self, page):
        self.refs[page] += 1

    def _maybe_free(self, page):
        if not self.refs[page] and not self.cache_refs[page]:
            self.free.append(page)
            self.frees += 1

    def decref(self, page):
        self.refs[page] -= 1
        self._maybe_free(page)

    def pin(self, page):
        self.cache_refs[page] += 1

    def unpin(self, page):
        self.cache_refs[page] -= 1
        self._maybe_free(page)

    def live_pages(self):
        return sum(1 for r in self.refs[1:] if r > 0)

    def cached_only_pages(self):
        """Pages held ONLY by the prefix cache — evicting their
        entries returns them to the free list immediately."""
        return sum(1 for p in range(1, self.num_pages + 1)
                   if self.cache_refs[p] and not self.refs[p])


class _PrefixCache:
    """Content-addressed cross-request prompt-prefix reuse over
    page-pool pages (the radix-tree idea of SGLang, flattened onto
    exact-byte keys: a prefix's own token bytes ARE its key, so there
    are no hash collisions to reason about).

    A finished prefill registers one entry per page-ALIGNED prefix
    boundary (those share only full, never-rewritten pages) plus one
    entry for the full prompt, which also carries the greedy first
    token — greedy decode makes tok0 a pure function of the prompt, so
    an exact-prompt repeat skips prefill compute entirely and answers
    with near-zero TTFT. Entries pin their pages via the pool's cache
    refcount; LRU entries evict under pool pressure (admission calls
    evict_for) and everything flushes at shutdown so drain ends with
    page_allocs == page_frees."""

    __slots__ = ("pool", "page_len", "max_entries", "entries",
                 "evictions")

    def __init__(self, pool, page_len, max_entries=256):
        self.pool = pool
        self.page_len = int(page_len)
        self.max_entries = int(max_entries)
        # prefix bytes -> (ntok, pages tuple, tok0 | None), LRU order
        self.entries = collections.OrderedDict()
        self.evictions = 0

    def match(self, ids):
        """Longest usable entry for prompt `ids`: the full prompt
        (with its cached first token) wins outright, else the longest
        page-aligned boundary <= plen-1 — the suffix prefill must
        still compute at least one position to produce tok0. Returns
        (ntok, pages, tok0) or None."""
        plen = int(ids.shape[0])
        key = ids.tobytes()
        ent = self.entries.get(key)
        if ent is not None and ent[0] == plen and ent[2] is not None:
            self.entries.move_to_end(key)
            return ent
        k = ((plen - 1) // self.page_len) * self.page_len
        while k >= self.page_len:
            key = ids[:k].tobytes()
            ent = self.entries.get(key)
            if ent is not None and ent[0] == k:
                self.entries.move_to_end(key)
                return ent
            k -= self.page_len
        return None

    def register(self, ids, table, tok0):
        """Index a freshly prefilled prompt: every page-aligned
        boundary plus the full prompt (carrying tok0). `table` is the
        sequence's page list; boundary entries take only full pages,
        the full-prompt entry also pins the (possibly partial) tail
        page — safe to share because readers only attend below plen
        and a full-hit copies the tail before its first write."""
        plen = int(ids.shape[0])
        pl = self.page_len
        for k in range(pl, (plen // pl) * pl + 1, pl):
            self._insert(ids[:k].tobytes(), k, table[:k // pl], None)
        self._insert(ids.tobytes(), plen, table[:-(-plen // pl)], tok0)

    def _insert(self, key, ntok, pages, tok0):
        ent = self.entries.get(key)
        if ent is not None:
            # already indexed (same bytes => same ntok); upgrade a
            # boundary entry with the full-prompt tok0 when it arrives
            if tok0 is not None and ent[2] is None:
                self.entries[key] = (ent[0], ent[1], tok0)
            self.entries.move_to_end(key)
            return
        pages = tuple(pages)
        for p in pages:
            self.pool.pin(p)
        self.entries[key] = (ntok, pages, tok0)
        while len(self.entries) > self.max_entries:
            self.evict_one()

    def evict_one(self):
        _, (_, pages, _) = self.entries.popitem(last=False)
        for p in pages:
            self.pool.unpin(p)
        self.evictions += 1

    def evict_for(self, need):
        """Evict LRU entries until the pool can cover an admission of
        `need` pages (or the cache is empty). Entries whose pages are
        still table-referenced free nothing now — their pages return
        when the referencing sequences finish."""
        while self.pool.available() < need and self.entries:
            self.evict_one()
        return self.pool.available() >= need

    def flush(self):
        while self.entries:
            self.evict_one()


class GenerationConfig:
    """Scheduler knobs. Unset values fall back to `serving_lm_*` /
    `serving_*` runtime flags (PADDLE_TPU_SERVING_LM_* env, the same
    spellings as the reference).

      max_slots        — KV slot pool size = the decode batch width
                         (the ONE decode shape).
      prefill_batch    — most prompts one prefill dispatch admits;
                         clamped to max_slots. Its pow-2 ladder (or
                         `batch_buckets`) bounds prefill batch shapes.
      max_prompt_len   — admission bound; its pow-2 ladder (or
                         `prompt_buckets`) bounds prefill length shapes.
      max_new_tokens   — per-request generation cap (requests may ask
                         for less; more is clamped).
      queue_limit      — bounded admission queue, like the batcher's.
      eos_id           — generation stops at (and includes) this token;
                         -1 = length-only stopping.
      continuous       — False = drain-then-batch baseline: admit only
                         into an EMPTY slot pool (the A/B control for
                         the continuous-batching TTFT win).
      paged            — True (the default) = block-granular paged KV:
                         sequences hold growable page tables over a
                         shared page pool instead of a fixed
                         max_cache_len slab, so short requests stop
                         paying long-request HBM. False = the slab
                         planes, kept as the measurable A/B baseline.
      page_len         — tokens per KV page (paged mode).
      num_pages        — page-pool size; 0 = auto-size to
                         max_slots * pages_per_seq (slab-equivalent
                         capacity). Smaller pools trade concurrency
                         headroom for HBM; admission reserves each
                         request's worst case up front so decode never
                         strands a live sequence waiting for a page.
      prefix_cache     — content-addressed cross-request prefix reuse
                         (paged mode only): prompts sharing a
                         page-aligned prefix pin the same pages and
                         skip the shared prefill compute.

    The cache depth is `max_cache_len = max_prompt_len +
    max_new_tokens`; it must fit the model's position table."""

    def __init__(self, max_slots=None, prefill_batch=None,
                 max_prompt_len=None, max_new_tokens=None,
                 queue_limit=None, default_deadline_ms=None, eos_id=-1,
                 prompt_buckets=None, batch_buckets=None,
                 continuous=True, paged=None, page_len=None,
                 num_pages=None, prefix_cache=None):
        self.max_slots = int(max_slots if max_slots is not None
                             else flags.get("serving_lm_max_slots"))
        if self.max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        pb = int(prefill_batch if prefill_batch is not None
                 else flags.get("serving_lm_prefill_batch"))
        self.prefill_batch = max(1, min(pb, self.max_slots))
        self.max_prompt_len = int(
            max_prompt_len if max_prompt_len is not None
            else flags.get("serving_lm_max_prompt_len"))
        self.max_new_tokens = int(
            max_new_tokens if max_new_tokens is not None
            else flags.get("serving_lm_max_new_tokens"))
        if self.max_prompt_len < 1 or self.max_new_tokens < 1:
            raise ValueError("max_prompt_len and max_new_tokens must "
                             "be >= 1")
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else flags.get("serving_queue_limit"))
        if self.queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        self.default_deadline_ms = default_deadline_ms
        self.eos_id = int(eos_id)
        self.continuous = bool(continuous)
        self.batch_buckets = batching.bucket_ladder(self.prefill_batch,
                                                    batch_buckets)
        self.prompt_buckets = batching.bucket_ladder(self.max_prompt_len,
                                                     prompt_buckets)
        self.max_cache_len = self.max_prompt_len + self.max_new_tokens
        self.paged = bool(flags.get("serving_lm_paged")
                          if paged is None else paged)
        self.page_len = int(page_len if page_len is not None
                            else flags.get("serving_lm_page_len"))
        if self.page_len < 1:
            raise ValueError("page_len must be >= 1")
        # pages covering one worst-case sequence = the per-request
        # reservation ceiling AND the per-row page-table width
        self.pages_per_seq = -(-self.max_cache_len // self.page_len)
        pool = int(num_pages if num_pages is not None
                   else flags.get("serving_lm_num_pages"))
        self.num_pages = pool or self.max_slots * self.pages_per_seq
        if self.paged and self.num_pages < self.pages_per_seq:
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold even one "
                f"worst-case sequence ({self.pages_per_seq} pages of "
                f"{self.page_len} tokens for max_cache_len="
                f"{self.max_cache_len})")
        self.prefix_cache = bool(flags.get("serving_lm_prefix_cache")
                                 if prefix_cache is None
                                 else prefix_cache)

    @classmethod
    def from_meta(cls, d, **overrides):
        """Config baked into an LM artifact's meta (the reference's
        `GenerationConfig.to_meta` layout), with overrides."""
        kw = {k: d.get(k) for k in ("max_slots", "prefill_batch",
                                    "max_prompt_len", "max_new_tokens",
                                    "eos_id", "prompt_buckets",
                                    "batch_buckets", "page_len",
                                    "num_pages", "prefix_cache")}
        if kw.get("eos_id") is None:
            kw["eos_id"] = -1
        # artifacts that predate paging baked slab planes — serve them
        # exactly as exported instead of adopting the new default
        kw["paged"] = bool(d.get("paged", False))
        kw.update(overrides)
        return cls(**kw)

    def rung_keys(self):
        """Every dispatch shape, as stable string keys: the one decode
        step plus the full (batch x prompt) prefill grid (and the
        copy-on-write page copy in paged mode). warmup() walks them."""
        keys = ["decode"]
        for b in sorted(self.batch_buckets, reverse=True):
            for t in sorted(self.prompt_buckets, reverse=True):
                keys.append(f"prefill:{b}x{t}")
        if self.paged:
            keys.append("page_copy")
        return keys


class GenerationStream:
    """Streaming handle for one submitted prompt.

    The engine pushes `("token", id)` events as they decode and exactly
    one terminal event — `("done", info)` or `("error", exc)`. Consume
    with `events()` / `tokens()` (iterators) or block on `result()`.
    `trace_id` is always set; `_span`/`_queue_span` carry the request-
    lifecycle spans when recording is on (None otherwise)."""

    __slots__ = ("prompt", "plen", "max_new", "deadline_s", "deadline_at",
                 "submitted_at", "trace_id", "slot", "first_token_at",
                 "last_token_at", "finish_reason", "_q", "_tokens",
                 "_error", "_done", "_span", "_queue_span", "_pos",
                 "_last_tok", "_cancelled", "_table", "_reserved",
                 "_start", "_tok0", "_cow")

    def __init__(self, prompt, max_new, deadline_s):
        self.prompt = prompt
        self.plen = int(prompt.shape[0])
        self.max_new = int(max_new)
        self.deadline_s = deadline_s
        now = time.monotonic()
        self.submitted_at = now
        # deadline 0 (or negative) = budget already exhausted, NOT
        # "no deadline"; only None disables it (engine.py contract)
        self.deadline_at = (now + deadline_s) if deadline_s is not None \
            else None
        self.trace_id = None
        self.slot = None
        self.first_token_at = None
        self.last_token_at = None
        self.finish_reason = None
        self._q = queue_mod.Queue()
        self._tokens = []
        self._error = None
        self._done = threading.Event()
        self._span = None
        self._queue_span = None
        self._pos = 0          # cache position the NEXT decode writes
        self._last_tok = 0     # the token the next decode step embeds
        self._cancelled = False   # set by engine.cancel(); honored at
        #                           the next decode-step boundary
        self._table = []       # paged mode: page ids, grown lazily
        self._reserved = 0     # pages still guaranteed but unallocated
        self._start = 0        # first cache position prefill computes
        #                        (> 0 after a prefix-cache hit)
        self._tok0 = None      # full-prompt hit: the cached first
        #                        token (prefill is skipped entirely)
        self._cow = None       # pending copy-on-write (src, dst)

    def expired(self, now=None):
        return (self.deadline_at is not None
                and (now if now is not None else time.monotonic())
                > self.deadline_at)

    def done(self):
        return self._done.is_set()

    # -- engine side --------------------------------------------------------

    def _emit(self, tok):
        self._tokens.append(tok)
        self._last_tok = tok
        self._q.put(("token", tok))

    def _finish_ok(self, reason):
        self.finish_reason = reason
        _finish(self._span)
        self._done.set()
        self._q.put(("done", {"finish_reason": reason,
                              "num_tokens": len(self._tokens)}))

    def _fail(self, error):
        self._error = error
        self.finish_reason = "error"
        _finish(self._queue_span, error=error)
        _finish(self._span, error=error)
        self._done.set()
        self._q.put(("error", error))

    # -- client side --------------------------------------------------------

    def events(self, timeout=None):
        """Yield `("token", id)` events then one `("done", info)`.
        A failed request raises its engine-assigned error (after any
        tokens that were already streamed)."""
        while True:
            kind, payload = self._q.get(timeout=timeout)
            if kind == "error":
                raise payload
            yield kind, payload
            if kind == "done":
                return

    def tokens(self, timeout=None):
        """Yield generated token ids as they decode."""
        for kind, payload in self.events(timeout=timeout):
            if kind == "token":
                yield payload

    def result(self, timeout=None):
        """Block for the full generation. Returns (ids int64 array,
        finish_reason). Raises the engine-assigned error for shed /
        rejected / failed requests."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation not done within "
                               f"{timeout}s (request still in flight)")
        if self._error is not None:
            raise self._error
        return np.asarray(self._tokens, np.int64), self.finish_reason


class GenerationEngine:
    """Thread-safe continuous-batching front end over the slotted
    decode loop. Constructed from a weights dict (`LMSpec` layout,
    numpy arrays) or an LM artifact file; a background scheduler thread
    owns the device: it admits+prefills, then decodes one fused step
    over all live slots, forever. `device=None` runs on the CUDA card
    (raises when there is none); tests pass `device="cpu"`."""

    def __init__(self, spec, weights, config=None, start=True,
                 ready=True, device=None):
        spec.validate_weights(weights)
        self.spec = spec
        self.config = config or GenerationConfig()
        if self.config.max_cache_len > spec.max_len:
            raise ValueError(
                f"max_prompt_len + max_new_tokens = "
                f"{self.config.max_cache_len} exceeds the model's "
                f"position table ({spec.max_len}) — shrink the caps or "
                "retrain with a longer pos_emb")
        self.device = resolve_device(device)
        self._hbm = self._price_hbm()
        self._build(weights)
        self._ready = bool(ready)
        self._cond = threading.Condition()
        self._queue = collections.deque()
        self._free = list(range(self.config.max_slots - 1, -1, -1))
        self._live = {}               # slot -> GenerationStream
        self._stopping = False
        self._drain = True
        self._closed = False
        self._stats = collections.Counter()
        self._warmup_s = {}
        self._warmed = ()
        self._dispatch_lock = threading.Lock()
        self._thread = None
        if start:
            self.start()

    # -- model plumbing -----------------------------------------------------

    def _build(self, weights):
        use_full_f32()
        w = lm_weights_from_numpy(weights, self.spec, self.device)
        params = tuple(w[f"stack.{leaf}"] for leaf in T._LEAVES)
        emb, pos_tab = w["tok_emb"], w["pos_emb"]
        lnfg, lnfb, headw = w["ln_f.w_0"], w["ln_f.w_1"], w["lm_head.w"]
        n = self.spec.num_heads
        head = (params, emb, pos_tab, lnfg, lnfb, headw, n)

        cfg = self.config
        L, S = self.spec.num_layers, cfg.max_slots
        D = self.spec.hidden_size // n
        if cfg.paged:
            shape = (L, cfg.num_pages + 1, n, cfg.page_len, D)
            self._pool = _PagePool(cfg.num_pages)
            self._prefix = (_PrefixCache(self._pool, cfg.page_len)
                            if cfg.prefix_cache else None)
            self._prefill_fn = lambda *a: T.paged_prefill(
                *head, self._ck, self._cv, *a)
            self._decode_fn = lambda *a: T.paged_decode_step(
                *head, self._ck, self._cv, *a)
        else:
            shape = (L, S, n, cfg.max_cache_len, D)
            self._pool = None
            self._prefix = None
            self._prefill_fn = lambda *a: T.slot_prefill(
                *head, self._ck, self._cv, *a)
            self._decode_fn = lambda *a: T.slot_decode_step(
                *head, self._ck, self._cv, *a)
        self._copy_fn = lambda src, dst: T.page_copy(self._ck, self._cv,
                                                     src, dst)
        # the planes are updated IN PLACE by every dispatch (the
        # counterpart of the reference's buffer donation: no step ever
        # holds two copies); created in inference mode like every
        # tensor the dispatches touch
        with torch.inference_mode():
            self._ck = torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)
            self._cv = torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)
        # the rungs' graphs, on the card only; the planes above stay
        # outside their memory pool
        self._graphs = (StepGraphs(self.device)
                        if self.device.type == "cuda" else None)

    def _price_hbm(self):
        """Price the resident engine in closed form BEFORE allocating
        anything — weights + both KV planes + the largest step's
        transients (activations of the biggest prefill rung or the
        decode step, one prefill layer's gathered page views, the head
        logits; on the card the rungs' CUDA graphs share one memory
        pool, which holds the largest rung's transients, and run on
        their own capture stream, which holds a cuBLAS workspace) — and
        refuse to construct when it exceeds the card's free memory
        (`torch.cuda.mem_get_info`). On the CPU there is no limit to
        check."""
        spec, cfg = self.spec, self.config
        H, F, V = spec.hidden_size, spec.ffn_hidden, spec.vocab_size
        n = spec.num_heads
        weight_bytes = 4 * sum(int(np.prod(s))
                               for s in spec.weight_specs().values())
        kv = price_kv_cache(spec, cfg)
        view = (cfg.pages_per_seq * cfg.page_len if cfg.paged
                else cfg.max_cache_len)

        def step(b, t):
            # x, h, qkv (3H), attention out + projection (2H), ffn up
            # and gelu (2F) per position; O/LSE rows; K/V views (the
            # paged prefill gathers one layer's pages per row, the
            # decode step reads them in place); head logits per row
            act = b * t * (7 * H + 2 * F + n)
            views = 2 * b * H * view if cfg.paged and t > 1 else 0
            return 4 * (act + views + b * V)

        transient = max(step(cfg.prefill_batch, cfg.max_prompt_len),
                        step(cfg.max_slots, 1))
        limit = None
        if self.device.type == "cuda":
            transient += _CUBLAS_WORKSPACE_BYTES
            limit = torch.cuda.mem_get_info(self.device)[0]
        out = {"kv_cache_bytes": kv, "weight_bytes": weight_bytes,
               "transient_bytes": transient,
               "peak_hbm_bytes": weight_bytes + kv + transient,
               "hbm_bytes_limit": limit}
        if limit is not None and out["peak_hbm_bytes"] > limit:
            raise ValueError(
                f"KV cache does not fit the device: weights "
                f"{weight_bytes} + KV planes {kv} + transients "
                f"{transient} bytes > {limit} bytes free on {self.device} "
                f"(max_slots={cfg.max_slots}, max_cache_len="
                f"{cfg.max_cache_len}; shrink either, or serve on a "
                "bigger device)")
        if monitor.enabled():
            monitor.gauge_set("serving_lm.kv_cache_bytes", kv)
        return out

    def _to_device(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    def _dispatch(self, key, fn, *host):
        """One rung: its CUDA graph on the card, the eager function on
        the CPU. Returns the outputs as numpy arrays; the read-back is
        the one point the host waits for the device."""
        with self._dispatch_lock, torch.inference_mode():
            if self._graphs is not None:
                return self._graphs.run(key, fn, *host)
            out = fn(*self._to_device(*host))
            return [] if out is None else [out.cpu().numpy()]

    def _dispatch_prefill(self, toks, *rest):
        """rest = (plen, slots) in slab mode, (start, plen, tables) in
        paged mode."""
        b, t = toks.shape
        tok0, = self._dispatch(f"prefill:{b}x{t}", self._prefill_fn, toks,
                               *rest)
        return tok0

    def _dispatch_decode(self, tok, pos_idx, live, tables=None):
        if tables is not None:
            # the decode attention attends to at most the keys a table
            # covers (it does not read kv_len back); refuse here, where
            # the positions are on the host
            keys = tables.shape[1] * self.config.page_len
            if int(np.max(pos_idx, initial=0)) >= keys:
                raise ValueError(f"decode position {int(np.max(pos_idx))} "
                                 f"is past the {keys} keys a page table "
                                 f"covers")
        args = ((tok, pos_idx, live) if tables is None
                else (tok, pos_idx, live, tables))
        nxt, = self._dispatch("decode", self._decode_fn, *args)
        return nxt

    def _dispatch_copy(self, src, dst):
        self._dispatch("page_copy", self._copy_fn,
                       np.array([src], np.int64), np.array([dst], np.int64))

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="paddle-tpu-torch-lm-sched",
                                            daemon=True)
            self._thread.start()
        return self

    def shutdown(self, drain=True, timeout=None):
        """Stop the scheduler. drain=True finishes every queued AND
        live generation first; drain=False fails them with
        EngineClosedError. Idempotent; submit() afterwards raises."""
        with self._cond:
            self._stopping = True
            self._drain = bool(drain)
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("lm scheduler did not stop within "
                                   f"{timeout}s")
        else:
            self._abandon_all()
        with self._cond:
            if self._prefix is not None:
                # release every prefix pin so a drained engine ends at
                # page_allocs == page_frees (the guard's invariant)
                self._prefix.flush()
        self._closed = True
        self._gauges()
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc == (None, None, None))

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens=None, deadline=None,
               trace_id=None):
        """Enqueue one prompt; returns a GenerationStream.

        `prompt`: 1-D int token ids, 1 <= len <= max_prompt_len, all in
        [0, vocab). `max_new_tokens` is clamped to the config cap and
        to the slot's remaining cache depth. `deadline`: seconds from
        now the caller still cares (enforced while queued and between
        decode steps; None = engine default). `trace_id`: adopt the
        caller's (an inbound `x-trace-id`); None generates one."""
        trace_id = trace_id or monitor.new_trace_id()
        root = monitor.start_span("serving_lm/request",
                                  trace_id=trace_id)
        admit = monitor.start_span("serving_lm/admit", parent=root)
        try:
            ids = np.asarray(prompt)
            if ids.ndim != 1 or ids.shape[0] < 1:
                raise ValueError("prompt must be a non-empty 1-D "
                                 f"token-id array, got shape "
                                 f"{tuple(ids.shape)}")
            if not np.issubdtype(ids.dtype, np.integer):
                raise ValueError("prompt must be integer token ids, "
                                 f"got dtype {ids.dtype}")
            if ids.shape[0] > self.config.max_prompt_len:
                raise ValueError(
                    f"prompt of {ids.shape[0]} tokens exceeds "
                    f"max_prompt_len {self.config.max_prompt_len} — "
                    "truncate it client-side")
            lo, hi = int(ids.min()), int(ids.max())
            if lo < 0 or hi >= self.spec.vocab_size:
                raise ValueError(f"prompt token ids must be in [0, "
                                 f"{self.spec.vocab_size}), got "
                                 f"[{lo}, {hi}]")
            ids = ids.astype(np.int32)
            cap = min(self.config.max_new_tokens,
                      self.config.max_cache_len - ids.shape[0])
            max_new = max(1, min(int(max_new_tokens), cap)
                          if max_new_tokens is not None else cap)
            if deadline is None and self.config.default_deadline_ms:
                deadline = self.config.default_deadline_ms / 1e3
            req = GenerationStream(ids, max_new, deadline)
            req.trace_id = trace_id
            req._span = root
            if root is not None:
                root.set_attr("prompt_len", req.plen)
                root.set_attr("max_new", max_new)
            with self._cond:
                if self._stopping or self._closed:
                    raise EngineClosedError("engine is shut down")
                depth = len(self._queue)
                if depth >= self.config.queue_limit:
                    self._stats["rejected"] += 1
                    monitor.counter_inc("serving_lm.rejected")
                    raise ServerOverloadedError(depth,
                                                self.config.queue_limit)
                req._queue_span = monitor.start_span(
                    "serving_lm/queue_wait", parent=root,
                    attrs={"depth_at_enqueue": depth})
                self._queue.append(req)
                self._stats["submitted"] += 1
                self._cond.notify_all()
        except BaseException as e:
            _finish(admit, error=e)
            _finish(root, error=e)
            raise
        _finish(admit)
        monitor.counter_inc("serving_lm.requests")
        self._gauges()
        return req

    def cancel(self, req):
        """Cancel a generation whose reader is gone (client
        disconnect): the scheduler drops it at the next decode-step
        boundary — queued requests are dropped at admit — and frees its
        KV slot immediately, instead of generating to completion for
        nobody. The stream finishes with finish_reason "cancelled"
        (tokens already emitted stay emitted). Returns True if the
        cancel was accepted, False if the request was already done."""
        with self._cond:
            if req.done() or req._cancelled:
                return False
            req._cancelled = True
            self._cond.notify_all()
        monitor.counter_inc("serving_lm.client_disconnects")
        return True

    def generate(self, prompt, max_new_tokens=None, deadline=None,
                 timeout=None, trace_id=None):
        """submit() and wait — the one-call convenience. Returns
        (ids int64 array, finish_reason)."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           deadline=deadline,
                           trace_id=trace_id).result(timeout)

    def warmup(self):
        """Run every dispatch shape once before traffic: every
        (batch x prompt-length) prefill rung plus the one decode step,
        largest first. On the card this builds the kernels and captures
        each rung's CUDA graph (a capture that fails raises with the
        rung key); on the CPU it runs each step once. Prefill warmups
        write through out-of-range slot ids (paged: the trash page),
        decode through an all-dead live mask — no slot state is
        perturbed, so warming a serving engine is safe. Per-rung
        seconds (on the card: capture and first replay) land in
        `serving_lm.warmup_s|rung=` histograms and stats()["warmup_s"]."""
        cfg = self.config
        S, m = cfg.max_slots, cfg.pages_per_seq
        rungs = []
        for key in cfg.rung_keys():
            t0 = time.perf_counter()
            if key == "decode":
                tables = (np.zeros((S, m), np.int32) if cfg.paged
                          else None)
                self._dispatch_decode(np.zeros((S,), np.int32),
                                      np.zeros((S,), np.int32),
                                      np.zeros((S,), bool),
                                      tables)
            elif key == "page_copy":
                # self-copy of the trash page: runs the COW copy
                # without touching any real page
                self._dispatch_copy(0, 0)
            elif cfg.paged:
                b, t = (int(x) for x in key.split(":")[1].split("x"))
                # all-zero tables: every write lands on the trash page
                self._dispatch_prefill(np.zeros((b, t), np.int32),
                                       np.zeros((b,), np.int32),
                                       np.ones((b,), np.int32),
                                       np.zeros((b, m), np.int32))
            else:
                b, t = (int(x) for x in key.split(":")[1].split("x"))
                self._dispatch_prefill(np.zeros((b, t), np.int32),
                                       np.ones((b,), np.int32),
                                       np.full((b,), S, np.int32))
            dt = time.perf_counter() - t0
            with self._cond:
                self._warmup_s[key] = round(dt, 6)
            monitor.histogram_observe(f"serving_lm.warmup_s|rung={key}",
                                      dt)
            rungs.append(key)
        self._warmed = tuple(rungs)
        self._ready = True
        return rungs

    @property
    def ready(self):
        return self._ready

    def set_ready(self, flag=True):
        self._ready = bool(flag)
        return self._ready

    # -- introspection ------------------------------------------------------

    def stats(self):
        """Always-on engine counters (independent of the metrics
        flag): the /healthz payload and the fleet dashboard's
        per-replica `serving_lm` section."""
        cfg = self.config
        with self._cond:
            depth = len(self._queue)
            live = len(self._live)
            snap = dict(self._stats)
            warmup_s = dict(self._warmup_s)
            occupied = sum(r.plen + len(r._tokens)
                           for r in self._live.values())
            kv_pages = None
            free_slots = cfg.max_slots - live
            kv_occ = occupied / float(cfg.max_slots * cfg.max_cache_len)
            if self._pool is not None:
                pool = self._pool
                free_p = len(pool.free)
                cached_only = pool.cached_only_pages()
                # a worst-case request needs pages_per_seq pages; the
                # cache's exclusively-held pages count as free (they
                # evict on demand) — the router's free_slots signal is
                # "admissions that will not queue on pages or slots"
                claimable = (max(0, pool.available()) + cached_only)
                free_slots = min(free_slots,
                                 claimable // cfg.pages_per_seq)
                kv_occ = 1.0 - free_p / float(pool.num_pages)
                kv_pages = {
                    "total": pool.num_pages, "free": free_p,
                    "live": pool.live_pages(), "cached": cached_only,
                    "reserved": pool.reserved,
                    "page_len": cfg.page_len,
                    "pages_per_seq": cfg.pages_per_seq,
                    "occupancy": round(kv_occ, 6),
                    "prefix_entries": (len(self._prefix.entries)
                                       if self._prefix else 0)}
                snap["page_allocs"] = pool.allocs
                snap["page_frees"] = pool.frees
                if self._prefix is not None:
                    snap["prefix_evictions"] = self._prefix.evictions
        out = {"kind": "lm",
               "queue_depth": depth, "queue_limit": cfg.queue_limit,
               "max_slots": cfg.max_slots, "live_slots": live,
               "free_slots": free_slots,
               "prefill_batch": cfg.prefill_batch,
               "batch_buckets": list(cfg.batch_buckets),
               "prompt_buckets": list(cfg.prompt_buckets),
               "max_prompt_len": cfg.max_prompt_len,
               "max_new_tokens": cfg.max_new_tokens,
               "max_cache_len": cfg.max_cache_len,
               "eos_id": cfg.eos_id,
               "continuous": cfg.continuous,
               "paged": cfg.paged,
               "kv_occupancy": round(kv_occ, 6),
               "hbm": dict(self._hbm),
               "warmed_rungs": list(self._warmed),
               "warmup_s": dict(sorted(warmup_s.items())),
               "aot_rungs": (self._graphs.keys()
                             if self._graphs is not None else []),
               "aot_status": ("cuda_graph" if self._graphs is not None
                              else "none"),
               "device": str(self.device),
               "closed": self._closed, "ready": self._ready,
               **{k: snap.get(k, 0) for k in
                  ("submitted", "completed", "shed", "rejected",
                   "errors", "abandoned", "cancelled", "slot_allocs",
                   "slot_frees", "admitted_mid_flight", "prefills",
                   "decode_steps", "tokens", "peak_live_slots",
                   "page_allocs", "page_frees", "prefix_hits",
                   "prefix_misses", "prefix_tokens_saved",
                   "cow_splits", "prefix_evictions")}}
        if kv_pages is not None:
            out["kv_pages"] = kv_pages
        return out

    # -- scheduler ----------------------------------------------------------

    def _count(self, key, n=1):
        with self._cond:
            self._stats[key] += n

    def _gauges(self):
        if not monitor.enabled():
            return
        cfg = self.config
        pages = None
        with self._cond:
            depth = len(self._queue)
            live = len(self._live)
            occupied = sum(r.plen + len(r._tokens)
                           for r in self._live.values())
            if self._pool is not None:
                pool = self._pool
                hits = self._stats.get("prefix_hits", 0)
                misses = self._stats.get("prefix_misses", 0)
                pages = (len(pool.free), pool.live_pages(),
                         pool.cached_only_pages(), pool.reserved,
                         1.0 - len(pool.free) / float(pool.num_pages),
                         hits / (hits + misses) if hits + misses else 0.0)
        monitor.gauge_set("serving_lm.queue_depth", depth)
        monitor.gauge_set("serving_lm.live_slots", live)
        if pages is None:
            monitor.gauge_set(
                "serving_lm.kv_occupancy",
                occupied / float(cfg.max_slots * cfg.max_cache_len))
        else:
            free_p, live_p, cached_p, reserved_p, occ, hit_rate = pages
            monitor.gauge_set("serving_lm.kv_occupancy", occ)
            monitor.gauge_set("serving_lm.kv_pages_free", free_p)
            monitor.gauge_set("serving_lm.kv_pages_live", live_p)
            monitor.gauge_set("serving_lm.kv_pages_cached", cached_p)
            monitor.gauge_set("serving_lm.kv_pages_reserved",
                              reserved_p)
            monitor.gauge_set("serving_lm.kv_pages_occupancy", occ)
            monitor.gauge_set("serving_lm.prefix_hit_rate", hit_rate)

    def _shed_queued(self, req, now):
        self._count("shed")
        monitor.counter_inc("serving_lm.deadline_shed")
        req._fail(DeadlineExceededError(now - req.submitted_at,
                                        req.deadline_s))

    def _free_slot(self, req):
        """Return `req`'s slot — and, paged, its pages and standing
        reservation — to the pool (caller holds no lock). Every finish
        path funnels here, so page accounting cannot leak."""
        with self._cond:
            if req.slot is None or self._live.get(req.slot) is not req:
                return
            del self._live[req.slot]
            self._free.append(req.slot)
            self._stats["slot_frees"] += 1
            if self._pool is not None:
                self._pool.reserved -= req._reserved
                req._reserved = 0
                if req._cow is not None:
                    # COW never dispatched (error path): drop the
                    # shared source page's admission reference
                    self._pool.decref(req._cow[0])
                    req._cow = None
                for page in req._table:
                    self._pool.decref(page)
                req._table = []

    def _shed_live(self, req, now):
        """Mid-generation deadline shed: fail the stream AND free the
        slot — the next admit reuses it immediately."""
        self._free_slot(req)
        self._count("shed")
        monitor.counter_inc("serving_lm.deadline_shed")
        req._fail(DeadlineExceededError(now - req.submitted_at,
                                        req.deadline_s))

    def _finish_req(self, req, reason):
        self._free_slot(req)
        self._count("completed")
        monitor.counter_inc("serving_lm.completed")
        monitor.histogram_observe("serving_lm.request_latency_s",
                                  time.monotonic() - req.submitted_at)
        req._finish_ok(reason)

    def _cancel_req(self, req):
        """Drop a cancelled generation: free the slot, finish the
        stream as "cancelled". NOT a completion (no completed count,
        no latency observation) — the client walked away."""
        self._free_slot(req)
        self._count("cancelled")
        _finish(req._queue_span)
        req._finish_ok("cancelled")

    def _emit_token(self, req, tok, now):
        req._emit(tok)
        self._count("tokens")
        monitor.counter_inc("serving_lm.tokens")
        if req.first_token_at is None:
            req.first_token_at = now
            monitor.histogram_observe("serving_lm.ttft_s",
                                      now - req.submitted_at)
        else:
            monitor.histogram_observe("serving_lm.inter_token_s",
                                      now - req.last_token_at)
        req.last_token_at = now
        eos = self.config.eos_id
        if eos >= 0 and tok == eos:
            self._finish_req(req, "eos")
        elif len(req._tokens) >= req.max_new:
            self._finish_req(req, "length")

    def _abandon_all(self):
        with self._cond:
            doomed = list(self._queue) + list(self._live.values())
            self._queue.clear()
        for req in doomed:
            self._free_slot(req)
            self._count("abandoned")
            req._fail(EngineClosedError(
                "engine shut down without draining generations"))

    def _loop(self):
        while True:
            with self._cond:
                while (not self._stopping and not self._queue
                       and not self._live):
                    self._cond.wait()
                stopping, drain = self._stopping, self._drain
                idle = not self._queue and not self._live
            if stopping and (idle or not drain):
                if not drain:
                    self._abandon_all()
                return
            try:
                self._admit_and_prefill()
                self._decode_step()
            except Exception as e:   # noqa: BLE001 — last resort: an
                # escape would kill the scheduler and hang every
                # stream; fail the affected requests instead
                self._count("errors")
                monitor.counter_inc("serving_lm.errors")
                with self._cond:
                    doomed = (list(self._live.values())
                              + list(self._queue))
                    self._queue.clear()
                monitor.blackbox.maybe_dump(
                    "serving_lm_step_failure", error=e,
                    extra={"trace_ids": [r.trace_id for r in doomed]})
                for req in doomed:
                    self._free_slot(req)
                    if not req.done():
                        req._fail(e)
            self._gauges()

    def _admit_pages(self, req):
        """Paged admission (self._cond held): match the prefix cache,
        claim the hit's shared pages, then reserve the request's
        WORST-CASE page count — evicting LRU cached prefixes if that is
        what it takes. Returns False (request stays queued,
        head-of-line) when the pool cannot cover the reservation even
        with an empty prefix cache; pages free as live sequences
        finish, so the head always admits eventually."""
        cfg = self.config
        pool = self._pool
        pl = cfg.page_len
        plen = req.plen
        matched, shared, tok0 = 0, (), None
        if self._prefix is not None:
            hit = self._prefix.match(req.prompt)
            if hit is not None:
                matched, shared, tok0 = hit
        full_hit = tok0 is not None and matched == plen
        if not full_hit:
            # a shorter prompt's full entry can match as a boundary —
            # its tok0 belongs to that prompt, not this one
            tok0 = None
        # claim the shared pages BEFORE any eviction below can unpin
        # them out from under us
        for page in shared:
            pool.incref(page)
        upto = -(-plen // pl)
        worst = -(-(plen + req.max_new) // pl)
        cow = full_hit and plen % pl != 0
        claim = worst - len(shared) + (1 if cow else 0)
        if pool.available() < claim and (
                self._prefix is None
                or not self._prefix.evict_for(claim)):
            for page in shared:
                pool.decref(page)
            return False
        table = list(shared)
        if cow:
            # the shared tail page is partially filled: the first
            # decode write (at pos=plen) would corrupt it for every
            # other pinner — copy it into an owned page first
            src = table[-1]
            table[-1] = pool.alloc()
            req._cow = (src, table[-1])   # src's claim drops after
            #                               the copy dispatches
            self._stats["cow_splits"] += 1
        while len(table) < upto:
            table.append(pool.alloc())
        pool.reserved += worst - upto
        req._reserved = worst - upto
        req._table = table
        req._start = plen if full_hit else matched
        req._tok0 = tok0
        if matched:
            self._stats["prefix_hits"] += 1
            self._stats["prefix_tokens_saved"] += matched
        elif self._prefix is not None:
            self._stats["prefix_misses"] += 1
        return True

    def _admit_and_prefill(self):
        now = time.monotonic()
        admitted, shed, cancelled = [], [], []
        with self._cond:
            live_before = len(self._live)
            blocked = not self.config.continuous and live_before > 0
            while (not blocked and self._queue and self._free
                   and len(admitted) < self.config.prefill_batch):
                req = self._queue[0]
                if req._cancelled:
                    # reader gone while queued: never takes a slot
                    self._queue.popleft()
                    cancelled.append(req)
                    continue
                if req.expired(now):
                    self._queue.popleft()
                    shed.append(req)
                    continue
                if self._pool is not None \
                        and not self._admit_pages(req):
                    break
                self._queue.popleft()
                req.slot = self._free.pop()
                self._live[req.slot] = req
                self._stats["slot_allocs"] += 1
                if len(self._live) > self._stats["peak_live_slots"]:
                    self._stats["peak_live_slots"] = len(self._live)
                admitted.append(req)
        for req in cancelled:
            self._cancel_req(req)
        for req in shed:
            self._shed_queued(req, now)
        if not admitted:
            return
        if live_before:
            self._count("admitted_mid_flight", len(admitted))
            monitor.counter_inc("serving_lm.admitted_mid_flight",
                                len(admitted))
        for req in admitted:
            if req._start:
                monitor.counter_inc("serving_lm.prefix_hits")
                monitor.counter_inc("serving_lm.prefix_tokens_saved",
                                    req._start)
            if req._cow is not None:
                src, _ = req._cow
                self._dispatch_copy(*req._cow)
                monitor.counter_inc("serving_lm.cow_splits")
                with self._cond:
                    req._cow = None
                    self._pool.decref(src)
        # full-prompt hits skip prefill compute entirely: the cached
        # greedy first token streams out immediately (near-zero TTFT)
        hits = [r for r in admitted if r._tok0 is not None]
        work = [r for r in admitted if r._tok0 is None]
        if hits:
            now = time.monotonic()
            for req in hits:
                _finish(req._queue_span)
                req._pos = req.plen
                self._emit_token(req, int(req._tok0), now)
        if not work:
            return
        S = self.config.max_slots
        paged = self._pool is not None
        b = batching.round_up_to_bucket(len(work),
                                        self.config.batch_buckets)
        t = batching.round_up_to_bucket(
            max(r.plen - r._start for r in work),
            self.config.prompt_buckets)
        toks = np.zeros((b, t), np.int32)
        plen = np.ones((b,), np.int32)
        if paged:
            start = np.zeros((b,), np.int32)
            tables = np.zeros((b, self.config.pages_per_seq), np.int32)
            for i, req in enumerate(work):
                _finish(req._queue_span)
                suffix = req.prompt[req._start:]
                toks[i, :suffix.shape[0]] = suffix
                start[i] = req._start
                plen[i] = req.plen
                tables[i, :len(req._table)] = req._table
            rest = (start, plen, tables)
        else:
            slots = np.full((b,), S, np.int32)   # pad rows: writes DROP
            for i, req in enumerate(work):
                _finish(req._queue_span)
                toks[i, :req.plen] = req.prompt
                plen[i] = req.plen
                slots[i] = req.slot
            rest = (plen, slots)
        trace_ids = [r.trace_id for r in work]
        self._count("prefills")
        monitor.counter_inc("serving_lm.prefills")
        monitor.histogram_observe("serving_lm.prefill_batch_size",
                                  len(work))
        t0 = time.perf_counter()
        with monitor.span("serving_lm/prefill",
                          attrs={"rows": len(work), "bucket_b": b,
                                 "bucket_t": t,
                                 "mid_flight": bool(live_before),
                                 "trace_ids": trace_ids}):
            tok0 = self._dispatch_prefill(toks, *rest)
        monitor.histogram_observe("serving_lm.prefill_s",
                                  time.perf_counter() - t0)
        if self._prefix is not None:
            with self._cond:
                for i, req in enumerate(work):
                    self._prefix.register(req.prompt, req._table,
                                          int(tok0[i]))
        now = time.monotonic()
        for i, req in enumerate(work):
            req._pos = req.plen
            self._emit_token(req, int(tok0[i]), now)

    def _decode_step(self):
        now = time.monotonic()
        with self._cond:
            live = dict(self._live)
        for slot, req in list(live.items()):
            if req._cancelled:
                # the decode-step boundary: the slot frees NOW, so the
                # next admit reuses the KV plane immediately
                self._cancel_req(req)
                del live[slot]
                continue
            if req.expired(now):
                self._shed_live(req, now)
                del live[slot]
        if not live:
            return
        S = self.config.max_slots
        tok = np.zeros((S,), np.int32)
        pos_idx = np.zeros((S,), np.int32)
        mask = np.zeros((S,), bool)
        tables = None
        if self._pool is not None:
            # lazy page growth: a sequence whose NEXT write crosses a
            # page boundary takes a page out of its standing
            # reservation (guaranteed available by admission)
            pl = self.config.page_len
            tables = np.zeros((S, self.config.pages_per_seq), np.int32)
            with self._cond:
                for req in live.values():
                    need = req._pos // pl + 1
                    while len(req._table) < need:
                        req._table.append(self._pool.alloc())
                        self._pool.reserved -= 1
                        req._reserved -= 1
            for slot, req in live.items():
                tables[slot, :len(req._table)] = req._table
        for slot, req in live.items():
            tok[slot] = req._last_tok
            pos_idx[slot] = req._pos
            mask[slot] = True
        trace_ids = [r.trace_id for r in live.values()]
        self._count("decode_steps")
        monitor.counter_inc("serving_lm.decode_steps")
        t0 = time.perf_counter()
        with monitor.span("serving_lm/decode_step",
                          attrs={"live_slots": len(live),
                                 "trace_ids": trace_ids}):
            nxt = self._dispatch_decode(tok, pos_idx, mask, tables)
        monitor.histogram_observe("serving_lm.decode_step_s",
                                  time.perf_counter() - t0)
        now = time.monotonic()
        for slot, req in live.items():
            req._pos += 1
            self._emit_token(req, int(nxt[slot]), now)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_artifact(cls, path, config=None, start=True, device=None):
        """Serve an LM artifact written by the JAX package
        (`paddle_tpu.io.export_lm_artifact`): the npz weights payload and
        the baked model spec / serving config. The StableHLO blob and any
        AOT section are JAX executables and are not read."""
        from ..io import read_lm_artifact
        meta, weights = read_lm_artifact(path)
        lm_meta = meta["lm"]
        spec = LMSpec.from_meta(lm_meta["model"])
        if config is None:
            config = GenerationConfig.from_meta(lm_meta["serving"])
        return cls(spec, weights, config=config, start=start,
                   device=device)
