"""Speculative decoding: draft proposers for the serving engine.

A decode tick streams every weight once however many token positions
ride it, so verifying k draft tokens in one chunked forward call
(:func:`repro_torch.models.lm.verify_chunk`) costs about one decode tick
and can emit up to k+1 tokens.  The engine side lives in
``serving/engine.py`` (``spec=SpecConfig(...)``); this module owns the
proposal side, a port of the JAX package's ``repro/serving/
speculative.py``:

  * :class:`NgramProposer` — self-drafting prompt lookup: an n-gram table
    over each request's own context proposes the continuation that
    followed the most recent earlier occurrence of the current suffix.
    No model calls.
  * :class:`ModelDraft` — a small draft model decodes up to k tokens
    greedily against its own contiguous KV cache (one row per engine
    slot), through the contiguous decode kernel on the card.  Its prefill
    rides along with the target's prefill chunks; after verification
    :meth:`ModelDraft.commit` re-syncs the row to the accepted length.
  * :class:`TokenTree` / :func:`tree_arrays` — token-tree drafts for the
    ancestor-masked verify; :class:`AdaptiveDraft` and
    :func:`draft_caps` size each slot's draft.

Both proposers are deterministic (point-mass proposals), so the
accept/reject rule in :func:`repro_torch.serving.sampler.
spec_accept_batch` preserves the target sampling distribution exactly;
greedy requests stay token for token identical to plain decode.  The
host-side bookkeeping here is plain Python and numpy, the same as the
reference's, operation for operation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, lm
from repro_torch.models.layers import to_device
from repro_torch.serving.telemetry import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decode policy for :class:`repro_torch.serving.engine.
    ServeEngine` (``spec=SpecConfig(...)``).

    ``k`` is the maximum draft length per tick (the engine emits 1..k+1
    tokens per verify call).  ``proposer`` picks the draft source:
    ``"ngram"`` (default, free self-drafting) or ``"model"`` (requires
    ``draft_cfg``/``draft_params`` — a small chunk-capable model).

    ``adaptive=True`` turns on per-slot adaptive draft sizing
    (:class:`AdaptiveDraft`): an EWMA of each slot's acceptance ratio
    scales its draft cap between ``k_min`` and ``k``, so slots on
    rejection streaks stop paying for drafts that never land while slots
    with landing drafts keep the full budget.  Adaptive sizing only ever
    *shrinks* the proposal budget — the accept/reject rule is untouched
    — so greedy streams stay token-for-token identical to plain decode
    (and to non-adaptive speculation up to how many drafts ride each
    verify).

    ``tree=True`` drafts a *token tree* instead of a linear chain: the
    proposer emits up to ``branch`` candidate continuations per node
    (:meth:`DraftProposer.propose_tree`) within the same ``k``-node
    budget, and one ancestor-masked verify scores every root-to-leaf
    path at the same chunk width — tree width replaces chain length at
    equal verify cost."""

    k: int = 4
    proposer: str = "ngram"  # "ngram" | "model"
    ngram_max: int = 3  # longest suffix n-gram to look up
    ngram_min: int = 1
    draft_cfg: Optional[ModelConfig] = None
    draft_params: Any = None
    adaptive: bool = False  # per-slot EWMA acceptance -> draft caps
    k_min: int = 1  # adaptive floor (never shrink below this cap)
    ewma_decay: float = 0.5  # weight of the newest acceptance ratio
    tree: bool = False  # token-tree drafts through ancestor-masked verify
    branch: int = 2  # max candidate continuations per tree node


class TokenTree:
    """A draft token tree in flattened DFS layout.

    Nodes are stored append-only; node ``i`` (0-based) occupies verify
    *chunk position* ``i + 1`` (position 0 is the root — the current
    token), and ``parents[i]`` names its parent's chunk position (0 for
    children of the root).  Append order guarantees the layout invariant
    every consumer relies on: a parent's chunk position is strictly less
    than all of its children's, so the accept walk can resolve each
    node's parent before reaching it, and the accepted positions in
    ascending order *are* the root-to-leaf path in depth order.

    ``depths[i]`` is the node's depth below the root (first level = 1):
    the node's *logical* sequence position is ``base + depths[i]``, while
    its cache slot stays at the flat ``base + i + 1`` until the accepted
    path is compacted.
    """

    def __init__(self):
        self.tokens: List[int] = []
        self.parents: List[int] = []  # parent chunk position (0 = root)
        self.depths: List[int] = []  # node depth below the root (>= 1)

    @property
    def n(self) -> int:
        return len(self.tokens)

    def add(self, token: int, parent: int) -> int:
        """Append a node under chunk position ``parent``; returns the new
        node's chunk position."""
        pos = len(self.tokens) + 1
        if not 0 <= parent < pos:
            raise ValueError(
                f"parent {parent} out of range for node at position {pos}")
        self.tokens.append(int(token))
        self.parents.append(int(parent))
        self.depths.append(1 if parent == 0 else self.depths[parent - 1] + 1)
        return pos

    @classmethod
    def chain(cls, tokens) -> "TokenTree":
        """A degenerate linear tree — node ``j`` hangs off node ``j-1``."""
        t = cls()
        p = 0
        for tok in tokens:
            p = t.add(int(tok), p)
        return t

    def ancestor_mask(self, C: int) -> np.ndarray:
        """The ``(C, C)`` ancestor bitmask over chunk positions: row ``j``
        sets exactly position ``j``'s root path (itself included).
        Padding rows past the last node get *causal* (lower-triangular)
        rows, so a chain-shaped or empty tree yields the plain causal
        mask bit-for-bit — the linear-verify reduction."""
        n = self.n
        if n + 1 > C:
            raise ValueError(f"{n} nodes do not fit a width-{C} chunk")
        anc = np.zeros((C, C), bool)
        anc[0, 0] = True
        for j in range(1, n + 1):
            anc[j] = anc[self.parents[j - 1]]
            anc[j, j] = True
        for j in range(n + 1, C):
            anc[j, :j + 1] = True
        return anc

    def padded_depths(self, C: int) -> np.ndarray:
        """Per-chunk-position depths, ``(C,)`` i32: root 0, node ``i`` at
        ``depths[i]``, padding positions at their causal offset (matching
        the linear chunk's ``base + j`` positions exactly)."""
        d = np.arange(C, dtype=np.int32)
        d[1:self.n + 1] = self.depths
        return d


def tree_arrays(
    trees: List[Optional["TokenTree"]], k: int, C: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batch per-slot trees into the verify/accept arrays:
    ``(tokens (B, k), parents (B, k), n_nodes (B,), anc (B, C, C),
    depths (B, C))``.  Slots with no tree get the causal/chain layout
    (zero nodes), so their rows reduce to the linear verify exactly."""
    B = len(trees)
    tokens = np.zeros((B, k), np.int32)
    parents = np.tile(np.arange(k, dtype=np.int32), (B, 1))
    n_nodes = np.zeros((B,), np.int32)
    anc = np.tile(np.tril(np.ones((C, C), bool)), (B, 1, 1))
    depths = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    for b, t in enumerate(trees):
        if t is None or t.n == 0:
            continue
        n = t.n
        tokens[b, :n] = t.tokens
        parents[b, :n] = t.parents
        n_nodes[b] = n
        anc[b] = t.ancestor_mask(C)
        depths[b] = t.padded_depths(C)
    return tokens, parents, n_nodes, anc, depths


def draft_caps(slots, lengths, active, k: int, seq_ceiling,
               adaptive: Optional["AdaptiveDraft"] = None) -> np.ndarray:
    """Per-slot draft-length caps: never draft past the request's
    remaining generation budget (``max_new`` minus what it already
    emitted) or past the cache ceiling (the verify writes ``counts+1``
    positions starting at ``lengths[b]``).  ``adaptive`` (if given)
    further shrinks each slot's cap to its :meth:`AdaptiveDraft.cap` —
    shrink-only, so every safety bound above still holds."""
    caps = np.zeros((len(slots),), np.int32)
    for b, req in enumerate(slots):
        if req is None or not active[b]:
            continue
        top = k if adaptive is None else adaptive.cap(b)
        cap = min(top, req.max_new - len(req.out))
        if seq_ceiling is not None:
            cap = min(cap, seq_ceiling - 1 - int(lengths[b]))
        caps[b] = max(0, cap)
    return caps


class AdaptiveDraft:
    """Per-slot adaptive draft sizing: EWMA acceptance -> draft caps.

    Speculation's cost scales with the draft length (a k-token draft
    rides k extra verify positions and, for ``proposer="model"``, k
    draft-model steps) while its payoff scales with the *accepted*
    length.  This tracker keeps a per-slot EWMA of the acceptance ratio
    of each verify (``accepted / proposed``) and converts it into that
    slot's next draft cap, ``ceil(ewma * k)`` clamped to ``[k_min, k]``:
    a rejection streak halves the estimate each observation (with the
    default ``decay=0.5``) until the slot drafts only ``k_min`` tokens,
    and a single fully-accepted verify pulls it back up — recovery costs
    at most a few short-draft ticks.

    The tracker only ever shrinks *proposals*; acceptance itself is
    untouched, so greedy output streams are bit-identical with or
    without it.  New slots start optimistic (EWMA 1.0 => cap ``k``) —
    the first verify is the first evidence.  Zero-token proposals
    (``proposed == 0``: the n-gram table had no match, or the cap
    bounded to 0 by the request's remaining budget) are not evidence of
    rejection and leave the estimate untouched.
    """

    def __init__(self, k: int, k_min: int = 1, decay: float = 0.5):
        if not 0 <= k_min <= k:
            raise ValueError(f"k_min={k_min} must be in [0, k={k}]")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"ewma_decay={decay} must be in (0, 1]")
        self.k = k
        self.k_min = k_min
        self.decay = decay
        self._ewma: Dict[int, float] = {}

    @classmethod
    def from_spec(cls, spec: "SpecConfig") -> Optional["AdaptiveDraft"]:
        if not spec.adaptive:
            return None
        return cls(spec.k, k_min=spec.k_min, decay=spec.ewma_decay)

    def alloc(self, slot: int) -> None:
        self._ewma[slot] = 1.0

    def free(self, slot: int) -> None:
        self._ewma.pop(slot, None)

    def observe(self, slot: int, proposed: int, accepted: int) -> None:
        """Fold one verify's outcome into the slot's estimate."""
        if proposed <= 0 or slot not in self._ewma:
            return
        ratio = min(1.0, accepted / proposed)
        self._ewma[slot] += self.decay * (ratio - self._ewma[slot])

    def observe_tree(self, slot: int, n_nodes: int, path_len: int) -> None:
        """Tree-mode observation: the chain ``observe`` assumes every
        proposed position was on the (single) path, but a tree spends its
        node budget across branches — the meaningful efficiency signal is
        accepted-path-length over *proposed nodes* (tokens landed per
        node of verify width paid), so the EWMA keeps driving the node
        budget rather than saturating at the per-level acceptance."""
        self.observe(slot, n_nodes, path_len)

    def cap(self, slot: int) -> int:
        """The slot's current draft cap, in [k_min, k]."""
        e = self._ewma.get(slot, 1.0)
        # ceil: a slot is only ever denied a draft position its estimate
        # has fully given up on (cap k requires ewma > (k-1)/k)
        return max(self.k_min, min(self.k, -int(-e * self.k // 1)))

    def stats(self) -> Dict[str, float]:
        caps = [self.cap(b) for b in self._ewma]
        return {
            "adaptive_slots": len(caps),
            "adaptive_cap_mean": float(np.mean(caps)) if caps else 0.0,
        }


class DraftProposer:
    """Interface the engine drives.  ``propose`` is batched over slots;
    the lifecycle hooks mirror the target engine's slot lifecycle so
    stateful proposers (the draft model's KV cache, the n-gram tables)
    stay in sync with admission, chunked prefill, and retirement."""

    #: span recorder the owning engine injects (``engine.tel.tracer``);
    #: the class default is the no-op singleton so a stand-alone proposer
    #: (tests, other engines) costs nothing
    tracer = NULL_TRACER

    def alloc(self, slot: int, prompt: List[int], filled: int) -> None:
        """A request was admitted to ``slot``; ``filled`` prompt tokens
        are already covered (prefix-sharing hit) and will not be
        prefilled."""

    def prefill_chunk(self, slot: int, chunk: np.ndarray, offset: int,
                      n: int) -> None:
        """The engine prefilled ``n`` prompt tokens (``chunk[:n]``) into
        ``slot`` at absolute ``offset``."""

    def propose(
        self,
        slots,  # List[Optional[Request]] — the engine's slot table
        cur_tok: np.ndarray,  # (B, 1) last emitted (uncached) token
        lengths: np.ndarray,  # (B,) target cache lengths
        active: np.ndarray,  # (B,) bool — slots decoding this tick
        caps: np.ndarray,  # (B,) per-slot draft-length cap (<= k)
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Return ``(draft (B, k) i32, counts (B,) i32)`` with
        ``counts[b] <= caps[b]`` valid tokens per active row."""
        raise NotImplementedError

    def propose_tree(
        self,
        slots,  # List[Optional[Request]] — the engine's slot table
        cur_tok: np.ndarray,  # (B, 1) last emitted (uncached) token
        lengths: np.ndarray,  # (B,) target cache lengths
        active: np.ndarray,  # (B,) bool — slots decoding this tick
        caps: np.ndarray,  # (B,) per-slot *node budget* (<= k)
        branch: int = 2,  # max candidate continuations per node
    ) -> List[Optional["TokenTree"]]:
        """Return one :class:`TokenTree` per slot (``None`` for inactive
        or empty rows) with at most ``caps[b]`` nodes.  The base
        implementation wraps :meth:`propose` into degenerate chains, so
        every proposer is tree-capable; branchy proposers override it."""
        draft, counts = self.propose(slots, cur_tok, lengths, active, caps)
        trees: List[Optional[TokenTree]] = []
        for b in range(len(slots)):
            n = int(counts[b])
            trees.append(TokenTree.chain(draft[b, :n]) if n > 0 else None)
        return trees

    def commit(self, slot: int, context: List[int], new_len: int) -> None:
        """Verification committed ``new_len`` cache positions for
        ``slot``; ``context[p]`` is the token at position ``p``."""

    def free(self, slot: int) -> None:
        """The request in ``slot`` retired."""


class NgramProposer(DraftProposer):
    """Self-drafting prompt lookup (the n-gram table flavour of
    speculative decoding: no draft model, no extra model calls).

    Per slot, a table maps every ``n``-gram (``ngram_min <= n <=
    ngram_max``) of the request's context to the positions right after
    its occurrences.  ``propose`` looks up the context's current suffix,
    longest n first, and drafts the continuation of the most recent
    *earlier* occurrence.  The table extends incrementally as the context
    grows (each token indexes O(ngram_max) entries once); rejected draft
    tokens never enter the context, so nothing is ever un-indexed."""

    def __init__(self, k: int, n_max: int = 3, n_min: int = 1):
        assert 1 <= n_min <= n_max
        self.k = k
        self.n_max = n_max
        self.n_min = n_min
        # slot -> [indexed prefix length, {ngram: [continuation starts]}]
        self._tables: Dict[int, list] = {}

    def alloc(self, slot, prompt, filled):
        self._tables[slot] = [0, {}]

    def free(self, slot):
        self._tables.pop(slot, None)

    def _extend(self, slot: int, ctx: List[int]) -> Dict:
        state = self._tables[slot]
        done, table = state
        for end in range(done + 1, len(ctx) + 1):
            for n in range(self.n_min, min(self.n_max, end) + 1):
                table.setdefault(tuple(ctx[end - n:end]), []).append(end)
        state[0] = len(ctx)
        return table

    def _lookup(self, table: Dict, ctx: List[int], cap: int) -> List[int]:
        L = len(ctx)
        for n in range(min(self.n_max, L), self.n_min - 1, -1):
            occs = table.get(tuple(ctx[L - n:]))
            if not occs:
                continue
            # most recent occurrence with a continuation (the suffix
            # itself indexes continuation start == L: nothing follows yet)
            for start in reversed(occs):
                if start < L:
                    return ctx[start:start + cap]
        return []

    def _lookup_multi(self, table: Dict, ctx: List[int],
                      width: int) -> List[int]:
        """Up to ``width`` *distinct* candidate next-tokens for the
        context's current suffix, ordered longest-n-gram first and most
        recent occurrence first within an n — the first candidate is
        exactly what :meth:`_lookup` would draft, so a width-1 tree walk
        reproduces the chain proposal."""
        L = len(ctx)
        cands: List[int] = []
        for n in range(min(self.n_max, L), self.n_min - 1, -1):
            occs = table.get(tuple(ctx[L - n:]))
            if not occs:
                continue
            for start in reversed(occs):
                if start < L and ctx[start] not in cands:
                    cands.append(ctx[start])
                    if len(cands) >= width:
                        return cands
        return cands

    def propose(self, slots, cur_tok, lengths, active, caps):
        B = len(slots)
        draft = np.zeros((B, self.k), np.int32)
        counts = np.zeros((B,), np.int32)
        for b, req in enumerate(slots):
            if not active[b] or caps[b] <= 0 or req is None:
                continue
            ctx = req.prompt + req.out  # out[-1] == cur_tok[b]
            table = self._extend(b, ctx)
            toks = self._lookup(table, ctx, int(caps[b]))
            counts[b] = len(toks)
            draft[b, :len(toks)] = toks
        return draft, counts

    def propose_tree(self, slots, cur_tok, lengths, active, caps, branch=2):
        trees: List[Optional[TokenTree]] = [None] * len(slots)
        for b, req in enumerate(slots):
            if not active[b] or caps[b] <= 0 or req is None:
                continue
            ctx = req.prompt + req.out
            table = self._extend(b, ctx)
            tree = TokenTree()
            budget = int(caps[b])

            # each node spawns up to `branch` distinct continuations; all
            # siblings are added before any subtree recurses so ambiguity
            # near the root keeps its candidates even on a tight budget
            def grow(parent_pos: int, path: List[int]) -> None:
                nonlocal budget
                if budget <= 0:
                    return
                kids = []
                for tok in self._lookup_multi(table, path, branch):
                    if budget <= 0:
                        break
                    kids.append((tree.add(tok, parent_pos), tok))
                    budget -= 1
                for pos, tok in kids:
                    grow(pos, path + [tok])

            grow(0, ctx)
            trees[b] = tree if tree.n else None
        return trees


class ModelDraft(DraftProposer):
    """Small-model draft: up to k batched greedy decode steps per tick —
    one per position of the batch's largest per-slot cap, so adaptive
    caps cut draft forwards too — against the draft model's own
    contiguous KV cache (``lm.init_cache(layout="stacked")``, one row per
    engine slot, in the engine's activation dtype as in the reference).

    The draft cache mirrors the target slot for slot: admission resets
    the row, target prefill chunks replay through the draft model (plus
    a catch-up prefill for prefix-shared tokens the target never
    prefills), and :meth:`commit` re-syncs the row to the verified
    length.  During ``propose``, rows past their cap (and non-decoding
    rows) freeze: they rewrite their last token at a fixed position,
    which is either above the committed length or rewritten by the next
    real write, so one fixed-shape batched call serves ragged per-slot
    budgets.  The draft decodes greedily whatever the request's sampling
    parameters — a deterministic proposal, which keeps the accept rule
    distribution-preserving."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        batch_slots: int,
        max_seq: int,
        k: int,
        *,
        chunk_size: int = 32,
        dtype=torch.bfloat16,
        device=None,
    ):
        if not blocks.page_addressable(cfg):
            # the draft cache rewinds by length alone (propose's frozen-row
            # rewrites, commit's re-sync): rings and recurrent states
            # mutate in place and have no such rewind here
            raise ValueError(
                "proposer='model' needs a pure global-attention draft "
                f"stack (got {cfg.block_pattern}); use proposer='ngram' "
                "for rotating-window/recurrent targets")
        lm.check_supported(cfg)
        self.cfg = cfg
        self.params = to_device(params, device)
        self.B = batch_slots
        self.max_seq = max_seq
        self.k = k
        self.chunk_size = min(chunk_size, max_seq)
        self.dtype = dtype
        self.device = device
        self.cache = lm.init_cache(cfg, batch_slots, max_seq,
                                   layout="stacked", dtype=dtype,
                                   device=device)
        self.lengths = np.zeros((batch_slots,), np.int32)  # clean fill
        self.draft_calls = 0  # draft model invocations (decode + prefill)
        # tree mode: slot -> (start, fed tokens) — what propose_tree wrote
        # into the draft cache this tick, reconciled against the accepted
        # path by commit()
        self._written: Dict[int, Tuple[int, List[int]]] = {}

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _step(self, toks: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """One batched draft decode step; (B, V) logits."""
        logits, self.cache = lm.decode_step(
            self.params, self.cfg, self._dev(toks.astype(np.int64)),
            self.cache, self._dev(pos.astype(np.int32)), dtype=self.dtype)
        self.draft_calls += 1
        return logits

    def alloc(self, slot, prompt, filled):
        self.lengths[slot] = 0
        if filled:
            # prefix-sharing hit: the target starts prefill past the
            # shared pages, but the draft cache holds nothing for them —
            # replay the covered prompt tokens through the draft model
            self._force(slot, prompt[:filled], 0)

    @torch.no_grad()
    def prefill_chunk(self, slot, chunk, offset, n):
        _, self.cache = lm.prefill_into_slot(
            self.params, self.cfg, self._dev(np.asarray(chunk, np.int64)),
            self.cache, offset, slot=slot, valid=n, dtype=self.dtype)
        self.draft_calls += 1
        self.lengths[slot] = offset + n

    def _force(self, slot: int, tokens: List[int], offset: int) -> None:
        """Teacher-force ``tokens`` into a draft row at ``offset``."""
        C = self.chunk_size
        for start in range(0, len(tokens), C):
            n = min(C, len(tokens) - start)
            chunk = np.zeros((C,), np.int64)
            chunk[:n] = tokens[start:start + n]
            self.prefill_chunk(slot, chunk, offset + start, n)

    @torch.no_grad()
    def propose(self, slots, cur_tok, lengths, active, caps):
        B, k = self.B, self.k
        draft = np.zeros((B, k), np.int32)
        counts = np.where(active, np.maximum(caps, 0), 0).astype(np.int32)
        # positions: active rows write at the target's length (the draft
        # cache is committed to the same length); frozen/inactive rows
        # rewrite a masked position (see class docstring)
        pos = np.where(active, lengths, self.lengths).astype(np.int32)
        pos = np.minimum(pos, self.max_seq - 1)
        toks = np.array(cur_tok, np.int64).reshape(B, 1).copy()
        # steps past every row's cap would only re-freeze frozen rows:
        # stop at the batch's largest cap, so shrunken (adaptive) caps
        # cut draft-model forwards, not just proposed tokens
        tr = self.tracer
        with tr.span("draft.propose", "spec", args=(
                {"steps": int(counts.max(initial=0)),
                 "rows": int(np.asarray(active, bool).sum())}
                if tr.enabled else None)):
            for j in range(int(counts.max(initial=0))):
                logits = self._step(toks, pos)
                nxt = logits.argmax(dim=-1).cpu().numpy().astype(np.int32)
                live = active & (j < counts)
                draft[live, j] = nxt[live]
                # advance and feed only rows still under their cap;
                # frozen rows keep (token, position), so the repeated
                # write is the same token at the same position
                adv = active & (j + 1 < np.minimum(counts + 1, k))
                pos = np.minimum(pos + adv.astype(np.int32),
                                 self.max_seq - 1)
                toks[adv, 0] = nxt[adv]
        # clean fill: positions L..L+min(cap, k-1) now hold real tokens
        upd = np.asarray(active, bool)
        self.lengths[upd] = (lengths[upd]
                             + np.minimum(counts[upd] + 1, k)).astype(
                                 np.int32)
        return draft, counts

    @torch.no_grad()
    def propose_tree(self, slots, cur_tok, lengths, active, caps, branch=2):
        """Medusa-style tree drafting: walk the greedy *spine* through the
        draft model, and at every step keep the top-``branch`` candidates
        — the argmax extends the spine (and is fed back), the runners-up
        hang off the same parent as single-node siblings.  A ``k``-node
        budget needs ``ceil(k / branch)`` draft forwards.  Candidates are
        ranked by a stable descending sort, so tied logits keep the lower
        token id first, as ``jax.lax.top_k`` does (``torch.topk`` leaves
        the order of ties unspecified).

        Cache writes follow the spine only; they are recorded per slot
        and reconciled in :meth:`commit` against the accepted path."""
        B = self.B
        branch = max(1, int(branch))
        budgets = np.where(active, np.maximum(caps, 0), 0).astype(np.int32)
        live0 = np.asarray(active, bool) & (budgets > 0)
        trees: List[Optional[TokenTree]] = [None] * B
        spine_pos = np.zeros((B,), np.int32)  # current spine chunk position
        for b in range(B):
            if live0[b] and slots[b] is not None:
                trees[b] = TokenTree()
        rem = np.where([t is not None for t in trees], budgets, 0)
        pos = np.where(active, lengths, self.lengths).astype(np.int32)
        pos = np.minimum(pos, self.max_seq - 1)
        toks = np.array(cur_tok, np.int64).reshape(B, 1).copy()
        fed = {b: [int(toks[b, 0])] for b in range(B) if trees[b] is not None}
        steps = int(np.ceil(rem / branch).max(initial=0))
        tr = self.tracer
        with tr.span("draft.propose_tree", "spec", args=(
                {"steps": steps, "branch": branch,
                 "rows": int(live0.sum())} if tr.enabled else None)):
            for _ in range(steps):
                logits = self._step(toks, pos)
                top = torch.sort(logits, dim=-1, descending=True,
                                 stable=True).indices[:, :branch]
                top = top.cpu().numpy().astype(np.int32)  # (B, branch)
                for b in range(B):
                    if trees[b] is None or rem[b] <= 0:
                        continue
                    w = min(branch, int(rem[b]))
                    p0 = trees[b].add(top[b, 0], int(spine_pos[b]))
                    for c in top[b, 1:w]:
                        trees[b].add(int(c), int(spine_pos[b]))
                    rem[b] -= w
                    spine_pos[b] = p0
                # feed the spine; rows out of budget freeze (rewrite the
                # same token at the same — masked or real — position)
                adv = np.asarray(
                    [trees[b] is not None and rem[b] > 0 for b in range(B)])
                pos = np.minimum(pos + adv.astype(np.int32),
                                 self.max_seq - 1)
                toks[adv, 0] = top[adv, 0]
                for b in np.flatnonzero(adv):
                    fed[b].append(int(top[b, 0]))
        for b, f in fed.items():
            # speculative writes are dirty until commit reconciles them
            self._written[b] = (int(lengths[b]), f)
            self.lengths[b] = int(lengths[b])
        return trees

    def commit(self, slot, context, new_len):
        rec = self._written.pop(slot, None)
        if rec is not None:
            # tree tick: the clean fill is however far the fed spine
            # agrees with the committed context; the rest (a diverging
            # accepted branch) is teacher-forced below
            start, fed = rec
            m = 0
            while (m < len(fed) and start + m < new_len
                   and fed[m] == context[start + m]):
                m += 1
            self.lengths[slot] = start + m
        fill = int(self.lengths[slot])
        if new_len > fill:
            # chain: full acceptance of a k-token draft leaves the bonus
            # position's token generated but never written (at most one
            # token); tree: the accepted path diverged from the spine
            self._force(slot, context[fill:new_len], fill)
        self.lengths[slot] = new_len

    def free(self, slot):
        self.lengths[slot] = 0
        self._written.pop(slot, None)


def make_proposer(
    spec: SpecConfig,
    batch_slots: int,
    max_seq: int,
    *,
    chunk_size: int = 32,
    dtype=torch.bfloat16,
    device=None,
) -> DraftProposer:
    if spec.proposer == "ngram":
        return NgramProposer(spec.k, n_max=spec.ngram_max,
                             n_min=spec.ngram_min)
    if spec.proposer == "model":
        if spec.draft_cfg is None or spec.draft_params is None:
            raise ValueError(
                "proposer='model' needs SpecConfig.draft_cfg and "
                ".draft_params")
        return ModelDraft(spec.draft_cfg, spec.draft_params, batch_slots,
                          max_seq, spec.k, chunk_size=chunk_size,
                          dtype=dtype, device=device)
    raise ValueError(f"unknown proposer {spec.proposer!r}")


def validate_spec(cfg: ModelConfig, spec: SpecConfig, max_seq: int) -> None:
    """Refuse a speculation config the stack cannot serve, as both
    engines do before they build a proposer."""
    if spec.k < 1:
        raise ValueError(f"SpecConfig.k={spec.k} must be >= 1")
    if spec.tree and spec.branch < 1:
        raise ValueError(f"SpecConfig.branch={spec.branch} must be >= 1")
    if "local_attn" in cfg.block_pattern:
        W = min(cfg.window, max_seq)
        if spec.k + 1 > W:
            raise ValueError(
                f"SpecConfig.k={spec.k}: a verify writes k+1 ring "
                f"positions but the rotating window holds {W} — "
                "state rewind needs k+1 <= W so an accepted write "
                "can never share a ring slot with a rejected one")
    if spec.tree and not blocks.page_addressable(cfg):
        raise ValueError(
            "tree speculation forks K/V across sibling branches, "
            "which only absolute-position attn caches support — "
            "rings rotate and recurrent states carry, neither can "
            "hold two candidate futures at once.  This stack has "
            f"kinds {sorted(set(cfg.block_pattern))}; use linear "
            "speculation (tree=False) for hybrid stacks")


def engine_draft(cfg: ModelConfig, spec: Optional[SpecConfig],
                 batch_slots: int, max_seq: int, *, chunk_size: int,
                 dtype, device, tracer
                 ) -> Tuple[Optional[DraftProposer], Optional[AdaptiveDraft]]:
    """An engine's proposer over its ``batch_slots`` slots and its draft
    sizer, after :func:`validate_spec`; ``(None, None)`` without
    speculation."""
    if spec is None:
        return None, None
    validate_spec(cfg, spec, max_seq)
    proposer = make_proposer(spec, batch_slots, max_seq,
                             chunk_size=chunk_size, dtype=dtype,
                             device=device)
    proposer.tracer = tracer
    return proposer, AdaptiveDraft.from_spec(spec)
