"""Host-side block-pool manager for the paged KV cache.

Pure numpy/python bookkeeping: which pages belong to which slot, what
each slot's current length is, and the ``(max_batch, pages_per_seq)``
page table the device kernels consume.  The actual KV pools are torch
tensors owned by the engine (``LM.init_paged_cache``); this class never
touches them - it only hands the engine a list of pending page copies
(copy-on-write) to apply before the next device write.

Sharing model (vLLM-style prefix caching + COW):

  * Every page carries a refcount = number of slot page tables that
    reference it.  ``fork`` clones a slot by bumping refcounts instead
    of copying KV; a write into a shared page triggers copy-on-write
    (fresh page + a pending device copy + table swap).
  * Full pages whose token content is known are registered in a
    chain-hash table (hash of (parent_hash, page_tokens)), so a new
    prompt can claim the longest already-materialized prefix and skip
    recomputing it.
  * When the last reference to a *registered* page is dropped the page
    is parked in a cached-LRU pool instead of being scrubbed: it is
    still claimable by a later prompt with the same prefix, and it is
    evicted (hash entries dropped) only when the allocator runs out of
    strictly-free pages.
  * Admission reserves room for one decode append beyond the prompt
    (``can_admit`` checks ``pages_for(n + 1)``): a prompt that exactly
    fills its pages would otherwise prefill, fail to append, and be
    preempted into a full replay - a quadratic livelock under a tight
    pool.

Rollback x refcount sharp edge (speculative decode)
---------------------------------------------------

The engine's verify step commits KV for *all* K+1 speculative columns
before acceptance is known (``mark_prefilled(sl + c)`` followed by
``rollback(sl + used)``), which puts four load-bearing constraints on
this class - they are asserted/honoured in :meth:`rollback` and
:meth:`_cow`, and violating any of them corrupts shared state silently:

1. **Rollback drops only this slot's references.**  A fork taken
   mid-step keeps reading the old tail page; ``rollback`` must go
   through :meth:`_drop_ref` (never the free list directly), so a page
   another slot still references survives, and a published
   last-reference page parks in the cached LRU exactly as on
   :meth:`free_slot`.
2. **Rollback must re-trim the slot's hash chain.**  The chain caches
   "pages already examined" per slot; if a rejected draft rolled
   ``seq_lens`` back across a page boundary, a later
   :meth:`register_pages` would otherwise *skip re-hashing* a page
   whose content has since been overwritten - publishing a stale hash
   that a future prompt could claim.  Hence ``del chain[n_tokens //
   page_size:]``.
3. **A COW performed for a column that is then rejected is kept.**  The
   copy is wasted work, never a correctness issue: the new page is
   exclusively owned, unpublished, and the next append simply
   overwrites it.  Undoing the copy would require re-taking the shared
   page reference *after* the fork may have diverged - strictly worse.
4. **Junk KV from rejected columns stays inside kept pages** at
   positions ``>= seq_lens``.  That is safe because every mask in the
   stack (decode, chunked prefill, verify, CUDA kernels and plain paths alike)
   cuts at ``seq_lens``, and the next append overwrites the junk in
   place.  No scrubbing pass exists, by design - do not add one that
   reads ``seq_lens`` concurrently with a pending rollback.

5. **A fork taken inside the commit/rollback window must be truncated.**
   Between ``mark_prefilled(sl + c)`` and ``rollback(sl + used)`` the
   slot's ``seq_lens`` counts rejected columns, so a plain
   :meth:`fork` would inherit junk tokens as real and keep references
   on tail pages about to be rolled back.  ``fork(slot, n_tokens)``
   shares only the pages covering the pre-commit (or accepted) prefix
   and re-trims the fork's hash chain, so refcounts stay conserved
   through the parent's rollback and a later :meth:`register_pages` on
   either slot re-hashes any page whose rolled-over content was
   overwritten.  Sequence-group fan-out (parallel sampling / beam)
   forks exactly this way.

Tensor parallelism note: under ``--tp`` the device pools are
KV-head-sharded, but this class is *oblivious* to it - page tables and
every mechanism above are replicated on the host, and each shard
applies the same table-driven writes to its head slice.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np


class PagedKVCache:
    """Fixed-size page pool + per-slot page tables.

    Lifecycle: alloc (optionally claiming shared prefix pages and
    optionally lazy, for chunked prefill) -> ensure_capacity/advance/
    mark_prefilled as KV is written -> free.  ``check_invariants``
    validates the full refcount/hash/LRU state.
    """

    def __init__(self, num_pages: int, page_size: int, max_batch: int,
                 pages_per_seq: int, max_cached_pages: int | None = None):
        assert num_pages >= 1 and page_size >= 1
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_batch = max_batch
        self.pages_per_seq = pages_per_seq
        # Cap on the cached-page LRU (None = uncapped): under
        # long-running multi-tenant churn every retired prefix parks its
        # pages here, and without a bound the *entire* free pool ends up
        # as dead single-use prefixes - each later allocation then pays
        # an LRU eviction + hash retraction instead of a free-list pop,
        # and a cold burst finds no strictly-free pages at all.  Excess
        # entries age out oldest-first at park time.
        if max_cached_pages is not None:
            assert max_cached_pages >= 0, max_cached_pages
        self.max_cached_pages = max_cached_pages
        self.page_table = np.zeros((max_batch, pages_per_seq), np.int32)
        self.seq_lens = np.zeros((max_batch,), np.int32)
        self._free_pages: list[int] = list(range(num_pages - 1, -1, -1))
        self._free_slots: list[int] = list(range(max_batch - 1, -1, -1))
        self._slot_pages: dict[int, list[int]] = {}
        # -- sharing state ------------------------------------------------
        self._refcount = np.zeros((num_pages,), np.int32)
        self._page_hash: dict[int, int] = {}     # page id -> chain hash
        self._hash_page: dict[int, int] = {}     # chain hash -> page id
        self._cached: OrderedDict[int, None] = OrderedDict()  # LRU, ref==0
        self._pending_copies: list[tuple[int, int]] = []      # (src, dst)
        # Per-slot prefix of already-examined chain hashes, so the
        # register_pages calls the engine makes after every chunk / page
        # fill stay O(new pages) instead of rehashing from position 0
        # (quadratic over a long sequence's lifetime).
        self._slot_chain: dict[int, list[int]] = {}
        # -- disaggregated handoff state ----------------------------------
        # Export pins (source side): pages whose contents are being
        # device-copied to another worker's pools.  A pinned page must
        # keep its bytes until the copy lands, so eviction (LRU take,
        # park age-out) skips it and an in-place COW of a refcount-1
        # published page is forced onto the copy path.  Pins are a
        # *content* guard, not table references - the refcount ==
        # table-refs conservation law is untouched.
        self._export_pins = np.zeros((num_pages,), np.int32)
        # Staged pages (destination side): taken out of the pool for an
        # in-flight import but not yet published.  They are neither
        # free, cached nor owned until publish_staged/abort_staged.
        self._staged: set[int] = set()

    # ------------------------------------------------------------ queries
    @property
    def free_page_count(self) -> int:
        """Strictly free pages (no reusable content)."""
        return len(self._free_pages)

    @property
    def available_page_count(self) -> int:
        """Pages the allocator can hand out: free + evictable cached
        (export-pinned cached pages are claimable but not evictable)."""
        return len(self._free_pages) + sum(
            1 for p in self._cached if not self._export_pins[p])

    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots)

    @property
    def active_slots(self) -> list[int]:
        return sorted(self._slot_pages)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def refcount(self, page: int) -> int:
        return int(self._refcount[page])

    def token_capacity(self, slot: int) -> int:
        """Tokens the slot's currently-allocated pages can hold."""
        return len(self._slot_pages[slot]) * self.page_size

    def slot_pages(self, slot: int) -> tuple[int, ...]:
        """The slot's page ids, in table order (read-only snapshot)."""
        return tuple(self._slot_pages[slot])

    def writable_token_capacity(self, slot: int) -> int:
        """Tokens the slot can hold without allocating OR copying: the
        allocation capacity truncated at the first *shared* page at or
        after seq_lens.  Writing into a refcount > 1 page needs a
        copy-on-write, so after a failed ``ensure_capacity`` a shrunk
        chunk must stop here, not at :meth:`token_capacity` - otherwise
        it would scatter K/V into a page a forked sibling still reads.
        (A published refcount-1 page does not truncate: COW retracts its
        hash without allocating, which cannot fail.)"""
        pages = self._slot_pages[slot]
        for idx in range(int(self.seq_lens[slot]) // self.page_size,
                         len(pages)):
            if self._refcount[pages[idx]] > 1:
                return idx * self.page_size
        return len(pages) * self.page_size

    def can_admit(self, n_tokens: int, shared: tuple[int, ...] = ()) -> bool:
        """True if a ``n_tokens`` sequence (with ``len(shared)`` leading
        prefix pages already materialized) can be admitted.

        Reserves one decode-append slot past the prompt: the first
        generated token must have somewhere to land, otherwise admission
        guarantees an immediate preemption (full-replay livelock on a
        tight pool).
        """
        need_total = self.pages_for(n_tokens + 1)
        need_new = need_total - len(shared)
        shared_cached = sum(1 for p in shared if p in self._cached
                            and not self._export_pins[p])
        avail = self.available_page_count - shared_cached
        return bool(self._free_slots and need_total <= self.pages_per_seq
                    and need_new <= avail)

    # ------------------------------------------------------- prefix cache
    def _chain_hashes(self, tokens: list[int]) -> list[int]:
        """Chain hash per full page of ``tokens`` (page i covers tokens
        [i*page, (i+1)*page)); h_i = hash((h_{i-1}, page_tokens))."""
        out = []
        h = 0
        for i in range(len(tokens) // self.page_size):
            h = hash((h, tuple(
                tokens[i * self.page_size:(i + 1) * self.page_size])))
            out.append(h)
        return out

    def lookup_prefix(self, tokens: list[int]) -> tuple[int, ...]:
        """Longest already-materialized prefix of ``tokens``, as page ids.

        Only full pages are shared, and at least one token is always
        left to compute (its logits produce the next token), so the
        match is capped at ``(len(tokens) - 1) // page_size`` pages.
        """
        out = []
        for h in self._chain_hashes(tokens[:len(tokens) - 1]):
            page = self._hash_page.get(h)
            if page is None:
                break
            out.append(page)
        return tuple(out)

    def register_pages(self, slot: int, tokens: list[int]) -> int:
        """Publish ``slot``'s full, already-written pages to the prefix
        table.  ``tokens`` is the slot's token stream; only pages fully
        covered by both ``tokens`` and ``seq_lens[slot]`` (KV actually
        on device) are eligible.  Each page is examined once per slot
        lifetime (the hash chain is cached and only extends); returns
        #pages registered.
        """
        pages = self._slot_pages[slot]
        chain = self._slot_chain.setdefault(slot, [])
        n_full = min(len(tokens), int(self.seq_lens[slot])) \
            // self.page_size
        registered = 0
        h = chain[-1] if chain else 0
        for i in range(len(chain), n_full):
            h = hash((h, tuple(
                tokens[i * self.page_size:(i + 1) * self.page_size])))
            chain.append(h)
            page = pages[i]
            if page in self._page_hash:
                continue          # already published (or claimed shared)
            if h in self._hash_page:
                continue          # identical content already canonical
            self._page_hash[page] = h
            self._hash_page[h] = page
            registered += 1
        return registered

    def _unregister(self, page: int) -> None:
        h = self._page_hash.pop(page, None)
        if h is not None:
            self._hash_page.pop(h, None)

    # ----------------------------------------------------------- allocator
    def _take_page(self) -> int:
        """Pop a strictly-free page, else evict the LRU (unpinned)
        cached page."""
        if self._free_pages:
            return self._free_pages.pop()
        for page in self._cached:                    # LRU order
            if not self._export_pins[page]:
                del self._cached[page]
                self._unregister(page)
                return page
        raise RuntimeError("page pool exhausted")

    def _park(self, page: int) -> None:
        """Drop a published page whose last reference just fell: park it
        in the cached LRU (still claimable by an identical prefix),
        aging out the oldest unpinned entries beyond
        ``max_cached_pages``."""
        self._cached[page] = None                    # most-recently used
        if self.max_cached_pages is not None:
            over = len(self._cached) - self.max_cached_pages
            if over > 0:
                aged = [p for p in self._cached
                        if not self._export_pins[p]][:over]
                for old in aged:
                    del self._cached[old]
                    self._unregister(old)
                    self._free_pages.append(old)

    def _claim(self, page: int) -> None:
        """Take one reference on a shared/cached page."""
        if self._refcount[page] == 0:
            assert page in self._cached, f"claim of free page {page}"
            del self._cached[page]
        self._refcount[page] += 1

    def take_pending_copies(self) -> list[tuple[int, int]]:
        """Drain (src, dst) page copies the engine must apply to the
        device pools before the next write."""
        out, self._pending_copies = self._pending_copies, []
        return out

    # ---------------------------------------------------------- lifecycle
    def alloc_slot(self, n_tokens: int, shared: tuple[int, ...] = (),
                   lazy: bool = False) -> int:
        """Claim a slot for an ``n_tokens`` sequence.

        ``shared`` are prefix pages (from :meth:`lookup_prefix`) claimed
        by reference - their KV is already on device, so ``seq_lens``
        starts at ``len(shared) * page_size``.  With ``lazy=False`` the
        remaining pages for all ``n_tokens`` are allocated up front and
        ``seq_lens`` is set to ``n_tokens`` (the caller prefills them in
        one shot).  With ``lazy=True`` (chunked prefill) no fresh pages
        are allocated yet; :meth:`ensure_capacity` grows the slot chunk
        by chunk and :meth:`mark_prefilled` advances ``seq_lens``.
        """
        if n_tokens < 1:
            # seq_lens == 0 is the stack-wide "free slot" sentinel; an
            # active slot must own at least one token.
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        if not self.can_admit(n_tokens, shared):
            raise RuntimeError(
                f"cannot admit sequence of {n_tokens} tokens "
                f"(free slots {self.free_slot_count}, "
                f"available pages {self.available_page_count}, "
                f"shared {len(shared)})")
        assert len(shared) * self.page_size < n_tokens, \
            "shared prefix must leave at least one token to compute"
        assert lazy or not shared, \
            "eager alloc would overwrite the shared prefix pages"
        slot = self._free_slots.pop()
        pages = []
        for p in shared:
            self._claim(p)
            pages.append(p)
        if not lazy:
            while len(pages) < self.pages_for(n_tokens):
                page = self._take_page()
                self._refcount[page] = 1
                pages.append(page)
        self._slot_pages[slot] = pages
        # Seed the hash chain with the claimed prefix (all registered),
        # so later register_pages calls only hash new pages.
        self._slot_chain[slot] = [self._page_hash[p] for p in shared]
        self.page_table[slot] = 0
        self.page_table[slot, :len(pages)] = pages
        self.seq_lens[slot] = (len(shared) * self.page_size if lazy
                               else n_tokens)
        return slot

    def fork(self, slot: int, n_tokens: int | None = None) -> int:
        """Clone ``slot`` into a fresh slot sharing every page (beam /
        parallel-sampling style).  No KV is copied; the first divergent
        append into a shared page triggers copy-on-write.

        ``n_tokens`` truncates the fork: it shares only the pages
        covering the first ``n_tokens`` of the parent and starts with
        ``seq_lens == n_tokens``.  This is what makes a fork taken
        inside the speculative-verify window safe (constraint 5 of the
        rollback x refcount contract above): between the engine's
        ``mark_prefilled(sl + c)`` and ``rollback(sl + used)`` the
        parent's ``seq_lens`` over-counts by the rejected columns, so a
        fork intended to share only the *accepted* prefix must be taken
        with ``n_tokens = sl + used``.  The truncated fork takes no
        reference on pages past ``pages_for(n_tokens)`` (they may be
        rolled back and freed under it), and its hash chain is
        re-trimmed to the full pages below ``n_tokens`` so a later
        :meth:`register_pages` re-hashes any page whose rolled-over
        content has since been overwritten.
        """
        if not self._free_slots:
            raise RuntimeError("no free slot to fork into")
        if n_tokens is None:
            n_tokens = int(self.seq_lens[slot])
        assert 1 <= n_tokens <= int(self.seq_lens[slot]), \
            (n_tokens, int(self.seq_lens[slot]))
        pages = self._slot_pages[slot][:self.pages_for(n_tokens)]
        new = self._free_slots.pop()
        for p in pages:
            self._refcount[p] += 1
        self._slot_pages[new] = list(pages)
        chain = self._slot_chain.get(slot, [])
        self._slot_chain[new] = chain[:n_tokens // self.page_size]
        self.page_table[new] = 0
        self.page_table[new, :len(pages)] = pages
        self.seq_lens[new] = n_tokens
        return new

    def _cow(self, slot: int, idx: int) -> bool:
        """Make page ``idx`` of ``slot`` exclusively owned (copy-on-write).
        Returns False when no page can be allocated for the copy."""
        pages = self._slot_pages[slot]
        old = pages[idx]
        pinned = bool(self._export_pins[old])
        if self._refcount[old] == 1 and not pinned:
            if old not in self._page_hash:
                return True
            # Sole owner but published: writes would corrupt the cached
            # prefix other requests may claim, so retract it instead of
            # copying (content diverges from the registered hash).
            self._unregister(old)
            return True
        try:
            new = self._take_page()
        except RuntimeError:
            return False
        self._refcount[new] = 1
        self._pending_copies.append((old, new))
        pages[idx] = new
        self.page_table[slot, idx] = new
        if pinned and self._refcount[old] == 1:
            # Export-pinned sole owner: the bytes must survive until the
            # cross-worker copy lands, so even the refcount-1 case goes
            # through a real copy and the original parks/frees via the
            # normal last-reference path (still pinned, never evicted).
            self._drop_ref(old)
        else:
            self._refcount[old] -= 1
        return True

    def ensure_capacity(self, slot: int, n_tokens: int) -> bool:
        """Back ``slot`` with writable pages for ``n_tokens`` total
        tokens.  Positions in ``[seq_lens, n_tokens)`` are about to be
        written, so any shared (or published) page in that range is
        copy-on-write'd and missing tail pages are allocated.

        Allocates as much as it can before giving up: on False the slot
        keeps whatever pages it gained (``token_capacity`` tells the
        caller how far a shrunk chunk can still go).
        """
        pages = self._slot_pages[slot]
        need = self.pages_for(n_tokens)
        if need > self.pages_per_seq:
            return False
        # COW any existing page the write range touches (only the page
        # holding seq_lens can be shared mid-page - full shared prefix
        # pages sit strictly below seq_lens).
        first_write = int(self.seq_lens[slot]) // self.page_size
        for idx in range(first_write, min(need, len(pages))):
            if not self._cow(slot, idx):
                return False
        while len(pages) < need:
            try:
                page = self._take_page()
            except RuntimeError:
                return False
            self._refcount[page] = 1
            pages.append(page)
            self.page_table[slot, len(pages) - 1] = page
        return True

    def ensure_append_capacity(self, slot: int) -> bool:
        """Make room for one more token in ``slot`` (decode append).

        The next token lands at position seq_lens[slot]; if that crosses
        into an unallocated page, grab one, and if it lands in a shared
        page, copy-on-write it.  Returns False (slot keeps its pages)
        when the pool is exhausted or the sequence is at the
        pages_per_seq ceiling - the caller preempts or retires.
        """
        return self.ensure_capacity(slot, int(self.seq_lens[slot]) + 1)

    def advance(self, slot: int) -> None:
        """Record that one token's KV was appended to ``slot``."""
        assert self.pages_for(int(self.seq_lens[slot]) + 1) <= len(
            self._slot_pages[slot]), "advance() without capacity"
        self.seq_lens[slot] += 1

    def mark_prefilled(self, slot: int, n_tokens: int) -> None:
        """Record that KV for positions [seq_lens, n_tokens) was written
        (one chunked-prefill step)."""
        assert n_tokens >= int(self.seq_lens[slot])
        assert n_tokens == int(self.seq_lens[slot]) or \
            n_tokens <= self.writable_token_capacity(slot), \
            "mark_prefilled() into an unallocated or still-shared page"
        self.seq_lens[slot] = n_tokens

    def free_slot(self, slot: int) -> None:
        """Retire a slot: drop its page references, zero its table row.

        A page whose last reference drops is recycled - into the cached
        LRU when it is a published prefix page (claimable by a later
        identical prompt), onto the free list otherwise.
        """
        pages = self._slot_pages.pop(slot)
        self._slot_chain.pop(slot, None)
        for p in pages:
            self._drop_ref(p)
        self._free_slots.append(slot)
        self.page_table[slot] = 0
        self.seq_lens[slot] = 0

    def _drop_ref(self, page: int) -> None:
        self._refcount[page] -= 1
        if self._refcount[page] == 0:
            if page in self._page_hash:
                self._park(page)
            else:
                self._free_pages.append(page)

    def rollback(self, slot: int, n_tokens: int) -> None:
        """Truncate ``slot`` back to ``n_tokens`` (speculative-decode
        rollback): positions past the accepted prefix hold rejected
        drafts' KV, so decrement ``seq_lens`` and drop the slot's
        reference on every page past ``pages_for(n_tokens)``.

        Refcounts are respected: a tail page a fork still reads only
        loses this slot's reference; a published last-reference page
        parks in the cached LRU exactly as on :meth:`free_slot`.  The
        hash chain is re-trimmed so later ``register_pages`` calls
        re-hash any page whose content the rollback invalidated.  The
        junk KV left inside kept pages (positions >= n_tokens) is never
        attended - every mask in the stack cuts at seq_lens - and the
        next append overwrites it in place.
        """
        assert 1 <= n_tokens <= int(self.seq_lens[slot]), \
            (n_tokens, int(self.seq_lens[slot]))
        keep = self.pages_for(n_tokens)
        pages = self._slot_pages[slot]
        while len(pages) > keep:
            p = pages.pop()
            self.page_table[slot, len(pages)] = 0
            self._drop_ref(p)
        chain = self._slot_chain.get(slot)
        if chain is not None:
            del chain[n_tokens // self.page_size:]
        self.seq_lens[slot] = n_tokens

    # ------------------------------------------------- disaggregated handoff
    def export_prefix(self, tokens: list[int]) -> tuple[list[int],
                                                        list[int]]:
        """Source side of a prefill->decode handoff: the longest
        already-materialized run of full pages covering ``tokens``, as
        parallel ``(pages, hashes)`` lists, with every returned page
        *export-pinned*.

        Unlike :meth:`lookup_prefix` the match is NOT capped at
        ``(len - 1) // page_size``: the importer claims through its own
        admission path, which re-applies the one-token-to-compute cap -
        shipping the final full page too lets the decode worker prefill
        only the partial tail.  Pins nest (a page may back several
        in-flight exports) and must be released with
        :meth:`release_export` once the device copy has landed (or the
        handoff is abandoned).  Pinned pages are never evicted, never
        age out of the LRU, and never have their bytes overwritten by an
        in-place COW - the content stays valid for the whole window.
        """
        pages: list[int] = []
        hashes: list[int] = []
        for h in self._chain_hashes(tokens):
            page = self._hash_page.get(h)
            if page is None:
                break
            pages.append(page)
            hashes.append(h)
        for p in pages:
            self._export_pins[p] += 1
        return pages, hashes

    def release_export(self, pages: list[int]) -> None:
        """Drop one export pin from each page (copy landed / abandoned)."""
        for p in pages:
            assert self._export_pins[p] > 0, \
                f"release_export of unpinned page {p}"
            self._export_pins[p] -= 1

    def stage_pages(self, n: int) -> list[int]:
        """Destination side: take ``n`` pages out of the pool for an
        in-flight import.  Staged pages are neither free, cached nor
        owned (refcount 0, unpublished) until :meth:`publish_staged`
        inserts them into the prefix table or :meth:`abort_staged`
        returns them.  Raises RuntimeError when the pool cannot supply
        ``n`` pages (the caller falls back to a plain submit)."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        if n > self.available_page_count:
            raise RuntimeError(
                f"cannot stage {n} pages "
                f"(available {self.available_page_count})")
        out = [self._take_page() for _ in range(n)]
        self._staged.update(out)
        return out

    def publish_staged(self, pages: list[int],
                       hashes: list[int]) -> list[int]:
        """Commit an import: the device copy into ``pages`` has landed
        and ``hashes`` are their chain hashes (from the exporter's
        :meth:`export_prefix`).  Each page is published into the prefix
        table and parked in the cached LRU - claimable by the very next
        admission exactly like a locally-retired prefix.  A hash this
        pool already holds keeps its canonical page; the duplicate
        staged page is freed.  Returns the pages actually published.
        """
        assert len(pages) == len(hashes)
        published = []
        for page, h in zip(pages, hashes):
            assert page in self._staged, f"publish of unstaged page {page}"
            self._staged.discard(page)
            if h in self._hash_page:
                self._free_pages.append(page)
                continue
            self._page_hash[page] = h
            self._hash_page[h] = page
            self._park(page)
            published.append(page)
        return published

    def abort_staged(self, pages: list[int]) -> None:
        """Mid-handoff cancellation: return staged pages to the free
        list without publishing (their contents are garbage)."""
        for page in pages:
            assert page in self._staged, f"abort of unstaged page {page}"
            self._staged.discard(page)
            self._free_pages.append(page)

    # ---------------------------------------------------------- integrity
    def check_invariants(self) -> None:
        """Raises AssertionError if the pool bookkeeping is inconsistent."""
        refs: dict[int, int] = {}
        for pages in self._slot_pages.values():
            for p in pages:
                refs[p] = refs.get(p, 0) + 1
        # refcount conservation: stored refcounts == table references
        for p in range(self.num_pages):
            assert int(self._refcount[p]) == refs.get(p, 0), \
                f"page {p}: refcount {int(self._refcount[p])} != " \
                f"{refs.get(p, 0)} table references"
        free = set(self._free_pages)
        cached = set(self._cached)
        owned = set(refs)
        staged = set(self._staged)
        assert len(free) == len(self._free_pages), "duplicate free page"
        assert not (free & owned), "page both free and owned"
        assert not (cached & owned), "page both cached and owned"
        assert not (free & cached), "page both free and cached"
        assert not (staged & (free | cached | owned)), \
            "staged page also free/cached/owned"
        assert len(free) + len(cached) + len(owned) + len(staged) == \
            self.num_pages, "page leak"
        for p in cached:
            assert p in self._page_hash, "cached page without a hash"
        if self.max_cached_pages is not None:
            pinned_cached = sum(1 for p in cached if self._export_pins[p])
            assert len(cached) - pinned_cached <= self.max_cached_pages, \
                f"cached LRU over its cap: {len(cached)} > " \
                f"{self.max_cached_pages} (+{pinned_cached} pinned)"
        for p in free:
            assert p not in self._page_hash, "free page still published"
        for p in staged:
            assert p not in self._page_hash, "staged page published"
            assert int(self._refcount[p]) == 0, "staged page referenced"
        assert (self._export_pins >= 0).all(), "negative export pin"
        for p in np.nonzero(self._export_pins)[0].tolist():
            assert p not in free, f"export-pinned page {p} on free list"
            assert p in self._page_hash, \
                f"export-pinned page {p} unpublished"
        assert {p: h for h, p in self._hash_page.items()} == \
            self._page_hash, "hash table not a bijection"
        assert not (set(self._free_slots) & set(self._slot_pages)), \
            "slot both free and active"
        assert len(self._free_slots) + len(self._slot_pages) == \
            self.max_batch, "slot leak"
        for slot, pages in self._slot_pages.items():
            assert len(pages) >= self.pages_for(int(self.seq_lens[slot]))
            assert len(pages) <= self.pages_per_seq
            assert list(self.page_table[slot, :len(pages)]) == pages
            assert not any(self.page_table[slot, len(pages):])
        for slot in self._free_slots:
            assert self.seq_lens[slot] == 0
