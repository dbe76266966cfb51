"""The near-tie rule: two computations' greedy streams of one model, held
against each other where their roundings differ.

Two computations of the same model round differently: the card's kernels
keep softmax probabilities in float32 where the plain versions on the CPU
round them to bf16, and on one device the float32 products of a batch of 8
rows and of 8 x 5 rows sum in other orders.  Their free-running greedy
streams are equal until the first near-tie that the two roundings break
apart, and part there for good.  So a pair of served streams passes when
it is equal up to where it parts and every parting is a near-tie:

* each computation's logits at the parting are recomputed along the calls
  that served its stream: :class:`ScheduleProbe` records every prefill
  chunk, decode step and verify call of each request while the engine
  runs, and :func:`logits_after` replays them with their tokens, widths,
  valid counts and batch rows;
* each side must prefer its own token (margin >= 0): a negative margin
  means the recomputation is not the computation that served the stream;
* the two sides' logits agree to ``LOGIT_REL_TOL`` of their range, and
  each margin is at most twice their largest logit difference, the most
  that difference can overturn.

A MoE router picks the top k of float32 probabilities, so two computations
can swap a token's k-th and (k+1)-th expert at a routing near-tie, which
moves the logits further than an attention ulp.  There the logits may
differ by more only if the first differing choice along the shared history
was such a tie (:func:`routing_split`) and the first computation, replayed
with its routers pinned to the second's choices (:class:`RouterProbe`),
agrees with the second again: only the tie is exempt, nothing after it.

The probes patch ``lm``'s serving entry points, the engine's ``_emit`` and
``moe.route`` for the length of a ``with``; the port's modules get no hook,
and none imports this one.  The replays of one hold share their leading
prefills through a :class:`Prefilled` that the hold owns and drops.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models import lm, moe

#: two computations' logits at a parting: their largest difference over
#: the range of the second's.  Both round activations to int8 at every
#: linear, so an ulp of difference upstream can flip one rounding; a broken
#: kernel moves the logits by O(1) of their range
LOGIT_REL_TOL = 0.1
#: the replay's cache shape by default: the reduced configs' engines
AGREE_MAX_SEQ, AGREE_PAGE, AGREE_CHUNK = 128, 16, 16
#: the leading prefills one :class:`Prefilled` keeps
PREFILLED_KEPT = 8


class NearTieFailure(RuntimeError):
    """A pair of streams the rule does not pass, or calls that do not
    replay the stream they served."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise NearTieFailure(msg)


class ScheduleProbe:
    """While entered, records the model calls ``eng`` makes for each
    request, by request id, in order: each prefill chunk (its offset,
    tokens and valid count), decode step (the position and the token fed)
    and verify call (its base, the row's tokens, its width, its valid
    count where the engine passed one, a tree's mask and depths, and the
    accepted path a compaction moved), and how many tokens of the stream
    each call emitted.  ``lm``'s serving entry points and the engine's
    ``_emit`` are patched for the run, as :class:`RouterProbe` patches the
    router; calls with other params (a draft model's) pass through
    unrecorded.  :func:`logits_after` replays these calls to recompute
    what the served stream sampled from."""

    def __init__(self, eng):
        self.eng = eng
        self.calls = {}

    @staticmethod
    def _host(t):
        # a copy: on the CPU the engine's tensors share its numpy buffers
        return None if t is None else t.to("cpu", copy=True)

    def _add(self, slot, **call):
        call["emitted"] = 0
        self.calls.setdefault(self.eng.slots[slot].rid, []).append(call)

    def __enter__(self):
        eng = self.eng
        self._saved = saved = (lm.prefill_into_slot, lm.decode_step,
                               lm.verify_chunk, lm.compact_accepted_path)
        prefill, step, verify, compact = saved

        def prefill_(params, cfg, tokens, cache, offset, **kw):
            if params is eng.params:
                self._add(kw["slot"], kind="prefill", pos=int(offset),
                          tokens=self._host(tokens),
                          valid=int(kw["valid"]))
            return prefill(params, cfg, tokens, cache, offset, **kw)

        def step_(params, cfg, token, cache, lengths, **kw):
            if params is eng.params:
                tok, lens = self._host(token), self._host(lengths)
                for b in torch.nonzero(kw["active"].cpu()).flatten().tolist():
                    self._add(b, kind="step", pos=int(lens[b]),
                              tokens=tok[b])
            return step(params, cfg, token, cache, lengths, **kw)

        def verify_(params, cfg, tokens, cache, lengths, **kw):
            if params is eng.params:
                toks, lens = self._host(tokens), self._host(lengths)
                valids = self._host(kw.get("valids"))
                anc = self._host(kw.get("anc"))
                depths = self._host(kw.get("depths"))
                for b, req in enumerate(eng.slots):
                    # a parked row: no valid token, or past the cache
                    if req is None or (int(lens[b]) >= eng.max_seq
                                       if valids is None else
                                       int(valids[b]) == 0):
                        continue
                    self._add(b, kind="verify", pos=int(lens[b]),
                              tokens=toks[b],
                              valid=None if valids is None
                              else int(valids[b]),
                              anc=None if anc is None else anc[b],
                              depths=None if depths is None else depths[b])
            return verify(params, cfg, tokens, cache, lengths, **kw)

        def compact_(cfg, cache, src, dst, **kw):
            if cache is eng.kv.cache:
                for b, req in enumerate(eng.slots):
                    if req is not None and req.rid in self.calls:
                        self.calls[req.rid][-1]["path"] = self._host(src[b])
            return compact(cfg, cache, src, dst, **kw)

        emit = eng._emit

        def emit_(req, tok, now):
            self.calls[req.rid][-1]["emitted"] += 1
            return emit(req, tok, now)

        (lm.prefill_into_slot, lm.decode_step, lm.verify_chunk,
         lm.compact_accepted_path) = prefill_, step_, verify_, compact_
        eng._emit = emit_
        return self

    def __exit__(self, *exc):
        (lm.prefill_into_slot, lm.decode_step, lm.verify_chunk,
         lm.compact_accepted_path) = self._saved
        del self.eng._emit
        self.eng = None


class DistScheduleProbe(ScheduleProbe):
    """:class:`ScheduleProbe` for a ``DistributedServeEngine``: the
    sharded entry points (``lm.sharded_prefill_into_slot``,
    ``sharded_decode_step``, ``sharded_verify_chunk``) are patched, where
    row b of shard s is the engine's global slot ``s * Bs + b``, so each
    request's calls are recorded as a single-device engine's are, for
    :func:`logits_after` to replay with ``rows = Bs``.  A tree's path
    compaction is not recorded, so a tree run is refused."""

    def __enter__(self):
        eng = self.eng
        _check(eng.spec is None or not eng.spec.tree,
               "DistScheduleProbe: a tree run's compaction is not recorded")
        Bs, host = eng.Bs, self._host
        self._saved = saved = (lm.sharded_prefill_into_slot,
                               lm.sharded_decode_step,
                               lm.sharded_verify_chunk)
        prefill, step, verify = saved

        def prefill_(params, cfg, mesh, tokens, caches, slots, offsets,
                     valids, actives, **kw):
            if params is eng.shard_params:
                for s in range(mesh.size):
                    if actives[s]:
                        self._add(s * Bs + int(slots[s]), kind="prefill",
                                  pos=int(offsets[s]),
                                  tokens=host(tokens[s]),
                                  valid=int(valids[s]))
            return prefill(params, cfg, mesh, tokens, caches, slots,
                           offsets, valids, actives, **kw)

        def step_(params, cfg, mesh, tokens, caches, lengths, **kw):
            if params is eng.shard_params:
                for s in kw["shards"]:
                    tok, lens = host(tokens[s]), host(lengths[s])
                    act = host(kw["actives"][s])
                    for b in torch.nonzero(act).flatten().tolist():
                        self._add(s * Bs + b, kind="step", pos=int(lens[b]),
                                  tokens=tok[b])
            return step(params, cfg, mesh, tokens, caches, lengths, **kw)

        def verify_(params, cfg, mesh, tokens, caches, lengths, **kw):
            if params is eng.shard_params:
                for s in kw["shards"]:
                    toks, lens = host(tokens[s]), host(lengths[s])
                    valids = (None if kw.get("valids") is None
                              else host(kw["valids"][s]))
                    for b in range(Bs):
                        req = eng.slots[s * Bs + b]
                        if req is None or (int(lens[b]) >= eng.max_seq
                                           if valids is None else
                                           int(valids[b]) == 0):
                            continue
                        self._add(s * Bs + b, kind="verify",
                                  pos=int(lens[b]), tokens=toks[b],
                                  valid=None if valids is None
                                  else int(valids[b]), anc=None,
                                  depths=None)
            return verify(params, cfg, mesh, tokens, caches, lengths, **kw)

        emit = eng._emit

        def emit_(req, tok, now):
            self.calls[req.rid][-1]["emitted"] += 1
            return emit(req, tok, now)

        (lm.sharded_prefill_into_slot, lm.sharded_decode_step,
         lm.sharded_verify_chunk) = prefill_, step_, verify_
        eng._emit = emit_
        return self

    def __exit__(self, *exc):
        (lm.sharded_prefill_into_slot, lm.sharded_decode_step,
         lm.sharded_verify_chunk) = self._saved
        del self.eng._emit
        self.eng = None


def _copy_layers(cache):
    return {"layers": [{k: t.clone() for k, t in layer.items()}
                       for layer in cache["layers"]]}


class Prefilled:
    """The caches that one hold's replays reached after their leading
    prefill chunks, for its later replays with the same model, chunks and
    shapes (the rule asks both computations at each parting, whose
    prefills are often the same calls); each replay starts from a copy.
    At most ``PREFILLED_KEPT``, the oldest dropped first.  A params tree
    is named by its place among the trees this object has seen, and kept
    alive with it, so no entry can be taken for another tree's."""

    def __init__(self):
        self._trees = []
        self._kept = {}

    def key(self, params, *shape) -> tuple:
        i = next((j for j, p in enumerate(self._trees) if p is params),
                 None)
        if i is None:
            i = len(self._trees)
            self._trees.append(params)
        return (i,) + shape

    def get(self, key):
        """``(logits, a copy of the cache)`` kept under ``key``, or None."""
        hit = self._kept.get(key)
        return None if hit is None else (hit[0], _copy_layers(hit[1]))

    def put(self, key, out, cache) -> None:
        while len(self._kept) >= PREFILLED_KEPT:
            del self._kept[next(iter(self._kept))]
        self._kept[key] = (out, _copy_layers(cache))


def logits_after(params, cfg, calls, prompt, history, dev, *,
                 max_seq=AGREE_MAX_SEQ, page=AGREE_PAGE, chunk=AGREE_CHUNK,
                 rows=1, layout="paged", prefilled=None, router=None):
    """The logits a served stream sampled its token ``len(history)`` from,
    recomputed on ``dev`` along the request's own call schedule ``calls``
    (:class:`ScheduleProbe`): every prefill chunk, decode step and verify
    call up to the one that emitted that token, replayed with the tokens,
    widths and valid counts the engine gave it, a verify's accepted
    prefix committed as the engine commits it (the ring and state rewind,
    an accepted tree path compacted), on the paged or the stacked cache.
    The request is row 0 of a batch of ``rows`` (the others parked), so
    every call has the engine's shapes: the float32 matrix products round
    differently at different row counts.  The tokens fed must be
    ``prompt + history`` (the shared history of the two streams held), or
    the probe is at fault.  A schedule that starts past position 0 (a
    shared prefix) is prefilled below it in chunks of ``chunk`` from 0.
    With ``prefilled`` (:class:`Prefilled`) the cache after the leading
    prefill chunks is taken from it or left in it.  With ``router`` (an
    entered :class:`RouterProbe`) every model call names its valid tokens
    and their first position to the probe, and nothing is taken from or
    left in ``prefilled``: the probe must see, or pin, every routing."""
    full = list(prompt) + list(history)
    n = len(history)
    paged = layout == "paged"
    f32 = torch.float32
    lengths = torch.full((rows,), max_seq, dtype=torch.int32)
    active = torch.zeros(rows, dtype=torch.bool, device=dev)
    active[0] = True
    if paged:
        n_pg = max_seq // page
        bt = torch.arange(1, 1 + n_pg, dtype=torch.int32, device=dev)
        bts = torch.zeros((rows, n_pg), dtype=torch.int32, device=dev)
        bts[0] = bt
        into, step, ver = ({"block_table": bt}, {"block_table": bts},
                           {"block_tables": bts})
    else:
        into, step, ver = {}, {}, {}

    def route_at(count, pos0):
        if router is not None:
            router.at(count, pos0)

    # the call that emitted the token, and which of its emitted tokens
    done = 0
    for last, call in enumerate(calls):
        if done + call["emitted"] > n:
            break
        done += call["emitted"]
    else:
        raise NearTieFailure(f"no recorded call emitted token {n}")
    q = n - done
    lead = next((j for j, c in enumerate(calls) if c["kind"] != "prefill"),
                len(calls))
    lead = min(lead, last + 1)
    below = calls[0]["pos"] if calls[0]["kind"] == "prefill" else 0
    keep = prefilled is not None and router is None and lead > 0
    key = hit = None
    if keep:
        key = prefilled.key(params, cfg, str(dev), max_seq, page, chunk,
                            rows, layout, tuple(full[:below]), tuple(
                                (c["pos"], c["valid"],
                                 tuple(c["tokens"].tolist()))
                                for c in calls[:lead]))
        hit = prefilled.get(key)
    if hit is not None:
        out, cache = hit
    else:
        cache = (lm.init_cache(cfg, 1 + n_pg, page, slots=rows,
                               slot_seq=max_seq, device=dev) if paged
                 else lm.init_cache(cfg, rows, max_seq, layout="stacked",
                                    device=dev))
        for off in range(0, below, chunk):
            piece = full[off:min(off + chunk, below)]
            toks = torch.zeros(chunk, dtype=torch.int64)
            toks[:len(piece)] = torch.tensor(piece)
            route_at(len(piece), off)
            lm.prefill_into_slot(params, cfg, toks.to(dev), cache, off,
                                 slot=0, valid=len(piece), dtype=f32, **into)
    for j in range(lead if hit is not None else 0, last + 1):
        c = calls[j]
        pos, toks = c["pos"], c["tokens"]
        # the tokens this call fed that the stream kept
        fed = c["valid"] if c["kind"] == "prefill" else (
            q + 1 if j == last else max(c["emitted"], 1))
        if c["kind"] != "verify" or c["anc"] is None:
            _check(toks.reshape(-1)[:fed].tolist() == full[pos:pos + fed],
                   f"logits_after: call {j} ({c['kind']} at {pos}) fed "
                   "tokens other than the history")
        route_at(fed, pos)
        if c["kind"] == "prefill":
            out, cache = lm.prefill_into_slot(
                params, cfg, toks.to(dev), cache, pos, slot=0,
                valid=c["valid"], dtype=f32, **into)
        elif c["kind"] == "step":
            tok = torch.zeros((rows, 1), dtype=torch.int64)
            tok[0, 0] = toks
            lengths[0] = pos
            lg, cache = lm.decode_step(params, cfg, tok.to(dev), cache,
                                       lengths.to(dev), active=active,
                                       dtype=f32, **step)
            out = lg[0]
        else:
            out, cache = _replay_verify(params, cfg, c, cache, lengths, dev,
                                        q if j == last else None, ver,
                                        max_seq, rows)
        if keep and j == lead - 1:
            prefilled.put(key, out, cache)
    return out.float().cpu()


def _replay_verify(params, cfg, c, cache, lengths, dev, q, ver, max_seq,
                   rows):
    """One recorded verify call of :func:`logits_after` on row 0: the
    row's tokens at base ``c["pos"]``; a chain with a valid count (rings or
    states) snapshots the ring slots first and commits the tokens the
    call emitted; a tree compacts the accepted path as the engine did.
    Returns (the logits of the ``q``-th token the call emitted, or None
    without ``q``; the cache)."""
    C = c["tokens"].shape[0]
    toks = torch.zeros((rows, C), dtype=torch.int64)
    toks[0] = c["tokens"]
    lengths[0] = c["pos"]
    lens = lengths.to(dev)
    f32 = torch.float32
    if c["anc"] is not None:
        anc = torch.tril(torch.ones((rows, C, C), dtype=torch.int32))
        depths = torch.arange(C).repeat(rows, 1)
        anc[0], depths[0] = c["anc"], c["depths"]
        lgs, cache = lm.verify_chunk(params, cfg, toks.to(dev), cache, lens,
                                     anc=anc.to(dev), depths=depths.to(dev),
                                     dtype=f32, **ver)
        path = c.get("path")
        nodes = (list(range(C)) if path is None else
                 [0] + (path[path < max_seq] - c["pos"]).tolist())
        if path is not None:
            src = torch.full((rows, path.shape[0]), max_seq,
                             dtype=torch.int64)
            src[0] = path
            dst = torch.full_like(src, max_seq)
            m = int((path < max_seq).sum())
            dst[0, :m] = c["pos"] + 1 + torch.arange(m)
            bts = ver.get("block_tables")
            cache = lm.compact_accepted_path(
                cfg, cache, src, dst,
                block_tables=None if bts is None else bts.cpu())
        return (None if q is None else lgs[0, nodes[q]]), cache
    if c["valid"] is None:
        lgs, cache = lm.verify_chunk(params, cfg, toks.to(dev), cache, lens,
                                     dtype=f32, **ver)
        return (None if q is None else lgs[0, q]), cache
    valids = torch.zeros(rows, dtype=torch.int32)
    valids[0] = c["valid"]
    counts = torch.zeros(rows, dtype=torch.int32)
    counts[0] = max(c["emitted"], 1)
    snap = lm.verify_snapshot(cfg, cache, lens, chunk=C)
    lgs, cache, traj = lm.verify_chunk(
        params, cfg, toks.to(dev), cache, lens, valids=valids.to(dev),
        with_traj=True, dtype=f32, **ver)
    cache = lm.commit_verify(cfg, snap, cache, traj, lens, counts.to(dev),
                             valids.to(dev), chunk=C)
    return (None if q is None else lgs[0, q]), cache


class RouterProbe:
    """While entered, records the router probabilities of row 0's tokens
    at every MoE routing call of the :func:`logits_after` it is given, by
    (layer, position): ``logits_after`` names the row's valid tokens and
    their first position before each model call (:meth:`at`).  With
    ``pin`` (another probe's records) each of those tokens whose top-k
    experts differ from the ones ``pin`` records at its (layer, position)
    is routed to ``pin``'s instead, with gates from its own probabilities,
    renormalised over the k where ``moe.route`` renormalises them
    (``cfg.norm_topk_prob``); ``pinned`` counts such choices."""

    def __init__(self, cfg, pin=None):
        self.L, self.k = cfg.n_layers, cfg.experts_per_token
        self.pin = pin
        self.rec = {}
        self.n = self.pos0 = self.calls = self.pinned = 0

    def at(self, n: int, pos0: int) -> None:
        self.n, self.pos0, self.calls = n, pos0, 0

    def __enter__(self):
        self._route = moe.route

        def route(p, xt, cfg, capacity_factor):
            r = self._route(p, xt, cfg, capacity_factor)
            probs = moe.router_probs(p, xt)
            layer, self.calls = self.calls % self.L, self.calls + 1
            keys = [(layer, self.pos0 + i) for i in range(self.n)]
            self.rec.update(zip(keys, probs[:self.n].cpu()))
            if self.pin is None:
                return r
            chosen = r.experts.cpu()
            for i, key in enumerate(keys):
                if key not in self.pin:
                    continue
                want = self.pin[key].sort(descending=True)[1][:self.k]
                if set(want.tolist()) != set(chosen[i].tolist()):
                    chosen[i] = want
                    self.pinned += 1
            experts = chosen.to(xt.device)
            gates = probs.gather(1, experts)
            if cfg.norm_topk_prob:
                gates = gates / gates.sum(dim=-1,
                                          keepdim=True).clamp_min(1e-9)
            slots, order, offsets = moe.sort_choices(experts, cfg.n_experts,
                                                     r.C)
            return moe.Routing(gates, experts, slots, r.C, r.probs, order,
                               offsets)

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def routing_split(ra, rb, k):
    """Where two probes' routers chose different top-``k`` experts: the
    count of such (layer, position) choices among the shared ones, and
    the first (by position, then layer: every choice depends only on
    earlier ones in that order) as ``(key, (gap_a, gap_b), diff, span)``:
    each side's gap between its k-th and (k+1)-th probability, the two
    sides' largest probability difference there and the range of ``b``'s
    probabilities.  That first split is a routing near-tie when the two
    sides agree there (``diff <= LOGIT_REL_TOL * span``, as the logits
    must) and both gaps are within ``2 * diff``."""
    keys = sorted(set(ra.rec) & set(rb.rec), key=lambda t: (t[1], t[0]))
    n_diff, first = 0, None
    for key in keys:
        pa, pb = ra.rec[key], rb.rec[key]
        sa, ia = pa.sort(descending=True)
        sb, ib = pb.sort(descending=True)
        if set(ia[:k].tolist()) == set(ib[:k].tolist()):
            continue
        n_diff += 1
        if first is None:
            first = (key, ((sa[k - 1] - sa[k]).item(),
                           (sb[k - 1] - sb[k]).item()),
                     (pa - pb).abs().max().item(), (sb[0] - sb[-1]).item())
    return n_diff, len(keys), first


def hold_streams(what, streams, prompts, logits_fns, n_new, moe_cfg=None):
    """Two computations' served streams (``streams = (a, b)``, rid ->
    tokens; ``prompts`` indexed by rid) must be equal up to where a pair
    parts, and each parting must be a near-tie.  Each computation's
    logits at the parting (``logits_fns = (fa, fb)``, each ``(rid,
    prompt, history, *, prefilled, router) -> logits``) are recomputed
    along the calls that served its stream (:func:`served_logits`), so
    each must prefer its own token: a negative margin (a side's logit for
    its own token less its logit for the other side's) means the
    recomputation is not the computation that served the stream, and
    fails.  Then the two agree to ``LOGIT_REL_TOL`` of their range, and
    each margin is at most twice their largest logit difference.  For a
    MoE stack (``moe_cfg``) the logits may instead differ by more where
    the two computations' routers chose different experts along the
    shared history, if the first such choice was a routing near-tie
    (:func:`routing_split`: there the two sides' router probabilities
    agree to ``LOGIT_REL_TOL`` of their range, and each side's gap at the
    top-k boundary is within twice their difference) and only the routing
    explains the rest: ``fa`` computed again with its routers pinned to
    ``fb``'s choices (:class:`RouterProbe`) agrees with ``fb`` to
    ``LOGIT_REL_TOL`` of their range.  The margins are held against the
    unpinned difference all the same.  The replays share one
    :class:`Prefilled`, dropped on return.  Returns the free-running
    agreement."""
    a_out, b_out = streams
    fa, fb = logits_fns
    _check(sorted(a_out) == sorted(b_out), f"{what}: a request was not "
           "served by both")
    total = sum(len(o) for o in b_out.values())
    free = sum(x == y for rid, o in b_out.items()
               for x, y in zip(o, a_out[rid]))
    prefilled = Prefilled()
    parted = 0
    for rid in sorted(b_out):
        a, b = a_out[rid], b_out[rid]
        _check(len(a) == len(b) == n_new, f"{what}: request {rid} length")
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        parted += 1

        def ask(fn, router=None):
            return fn(rid, prompts[rid], b[:i], prefilled=prefilled,
                      router=router)

        routing_tie = False
        if moe_cfg is None:
            la, lb = ask(fa), ask(fb)
        else:
            with RouterProbe(moe_cfg) as ra:
                la = ask(fa, ra)
            with RouterProbe(moe_cfg) as rb:
                lb = ask(fb, rb)
            n_diff, n_all, first = routing_split(
                ra, rb, moe_cfg.experts_per_token)
            if first is None:
                print(f"{what}: request {rid}: the routers chose the same "
                      f"experts at all {n_all} (layer, position) choices")
            else:
                (li, pos), gaps, diff, pspan = first
                routing_tie = (max(gaps) <= 2 * diff
                               and diff <= LOGIT_REL_TOL * pspan)
                print(f"{what}: request {rid}: the routers chose different "
                      f"experts at {n_diff} of {n_all} (layer, position) "
                      f"choices; the first, layer {li} position {pos}: "
                      f"top-k boundary gaps {gaps[0]:.3e}, {gaps[1]:.3e} "
                      f"(<= 2 x diff) against a probability difference "
                      f"{diff:.3e} = {diff / pspan:.3e} of their range (<= "
                      f"{LOGIT_REL_TOL}): "
                      f"{'a' if routing_tie else 'NOT a'} routing near-tie")
        err = (la - lb).abs().max().item()
        span = (lb.max() - lb.min()).item()
        m_a = (la[a[i]] - la[b[i]]).item()
        m_b = (lb[b[i]] - lb[a[i]]).item()
        tie = ", or a routing near-tie" if moe_cfg else ""
        print(f"{what}: request {rid} parts at token {i}: {a[i]} vs {b[i]};"
              f" logits max err {err:.3e} = {err / span:.3e} of their range "
              f"(<= {LOGIT_REL_TOL}{tie}); margins {m_a:.3e}, {m_b:.3e} "
              "(>= 0, <= 2 x err)")
        ok = err <= LOGIT_REL_TOL * span
        if not ok and routing_tie:
            with RouterProbe(moe_cfg, pin=rb.rec) as rp:
                lp = ask(fa, rp)
            err_p = (lp - lb).abs().max().item()
            ok = err_p <= LOGIT_REL_TOL * span
            print(f"{what}: request {rid}: with the first's routers pinned "
                  f"to the second's choices ({rp.pinned} (layer, position) "
                  f"choices moved) the logits max err is {err_p:.3e} = "
                  f"{err_p / span:.3e} of their range (<= {LOGIT_REL_TOL})")
        _check(ok, f"{what}: request {rid} logits err {err}")
        _check(m_a >= 0 and m_b >= 0,
               f"{what}: request {rid} parts at token {i} ({a[i]} vs {b[i]})"
               f" with margins {m_a}, {m_b}: a recomputation prefers the "
               "other side's token, so it is not the computation that "
               "served the stream")
        _check(max(m_a, m_b) <= 2 * err,
               f"{what}: request {rid} parts at token {i} with margins "
               f"{m_a}, {m_b} beyond twice the logit difference {err}")
    print(f"{what}: free-running greedy agreement {free}/{total} = "
          f"{free / total:.3f}; {parted} of {len(b_out)} stream pairs part, "
          "each at a near-tie")
    return free / total


def served_logits(params, cfg, schedule, dev, **shape):
    """``(rid, prompt, history, *, prefilled=None, router=None) ->
    logits``: :func:`logits_after` along request ``rid``'s calls in
    ``schedule`` (a :class:`ScheduleProbe`'s ``calls``), on ``dev``, at the
    engine's ``shape`` (``max_seq``, ``page``, ``chunk``, ``rows``,
    ``layout``).  A call without a ``prefilled`` keeps no prefill."""

    def fn(rid, prompt, history, *, prefilled=None, router=None):
        return logits_after(params, cfg, schedule[rid], prompt, history, dev,
                            prefilled=prefilled, router=router, **shape)

    return fn


def hold_taught(what, tokens, la, lb):
    """The near-tie rule for a stream ``tokens`` (B, n) computed with
    logits ``la`` (n + 1, B, V; ``tokens[:, i]`` is the argmax of
    ``la[i]``) against a second computation's logits ``lb`` taught the
    same stream: each row must be the second's greedy stream up to where
    they part, and at a parting each computation prefers its own token
    (both margins at least 0), the two computations' logits agree to
    ``LOGIT_REL_TOL`` of their range and each one's margin of its own
    token over the other's is at most twice their largest difference.
    (Taught the shared history, the second computation's logits up to
    the parting are those of its own free-running stream.)  Returns the
    rows' agreement (tokens before the first parting, over all)."""
    B, n = tokens.shape
    _check(la.shape == lb.shape == (n + 1,) + la.shape[1:] and bool(
        torch.isfinite(la).all() and torch.isfinite(lb).all()),
        f"{what}: logits of shape {tuple(la.shape)} / {tuple(lb.shape)} or "
        "non-finite")
    _check(np.array_equal(la[:n].argmax(-1).numpy().T, tokens),
           f"{what}: the stream is not its own logits' argmax")
    mine = lb[:n].argmax(-1).numpy().T
    same, parted = 0, 0
    for b in range(B):
        i = next((j for j in range(n) if mine[b, j] != tokens[b, j]), None)
        same += n if i is None else i
        if i is None:
            continue
        parted += 1
        a, o = int(tokens[b, i]), int(mine[b, i])
        x, y = la[i, b], lb[i, b]
        err = (x - y).abs().max().item()
        span = (y.max() - y.min()).item()
        m_a, m_b = (x[a] - x[o]).item(), (y[o] - y[a]).item()
        print(f"{what}: row {b} parts at token {i}: {a} vs {o}; logits max "
              f"err {err:.3e} = {err / span:.3e} of their range (<= "
              f"{LOGIT_REL_TOL}); margins {m_a:.3e}, {m_b:.3e} (>= 0, <= 2 "
              "x err)")
        _check(m_a >= 0 and m_b >= 0,
               f"{what}: row {b} parts at token {i} with margins {m_a}, "
               f"{m_b}: a side's logits prefer the other side's token")
        _check(err <= LOGIT_REL_TOL * span and max(m_a, m_b) <= 2 * err,
               f"{what}: row {b} parts at token {i} beyond a near-tie")
    err = (la[0] - lb[0]).abs().max().item()
    span = (lb[0].max() - lb[0].min()).item()
    _check(err <= LOGIT_REL_TOL * span, f"{what}: prefill logits err {err}")
    print(f"{what}: prefill logits max err {err:.3e} = {err / span:.3e} of "
          f"their range; greedy agreement {same}/{B * n} = "
          f"{same / (B * n):.3f}; {parted} of {B} rows part, each at a "
          "near-tie")
    return same / (B * n)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def whisper_run(params, cfg, frames, ragged, uniform, n_new, dev, *,
                max_seq, forced=None):
    """Whisper at model level, as the reference runs it: the ``ragged``
    prompts (rows ``0..R-1``, with ``frames[:R]``) replay through
    ``lm.prefill`` and the ``uniform`` ones (equal lengths, with
    ``frames[R:]``) through ``lm.batch_prefill``, each group on its own
    stacked cache (bf16 self K/V, ``max_seq`` positions; float32 cross
    K/V); the two caches join into one of all the rows, which then takes
    ``n_new`` greedy ``decode_step(enc_lengths=)`` steps, float32
    activations (a W8A8 engine's).  With ``forced`` (B, n_new) each step
    is fed those tokens instead (teacher forcing), for
    :func:`hold_taught`.  Returns (the tokens fed (B, n_new), the logits
    after the prefill and after each step on the CPU (n_new + 1, B, V),
    {"prefill_s", "decode_s"})."""
    dt = torch.float32
    R = len(ragged)
    parts = []
    _sync(dev)
    t0 = time.perf_counter()
    if ragged:
        plen = torch.tensor([len(p) for p in ragged], dtype=torch.int32)
        toks = torch.zeros((R, int(plen.max())), dtype=torch.int64)
        for b, p in enumerate(ragged):
            toks[b, :len(p)] = torch.tensor(p)
        c = lm.init_cache(cfg, R, max_seq, layout="stacked", device=dev)
        parts.append(lm.prefill(params, cfg, toks.to(dev), plen.to(dev), c,
                                frames=frames[:R], dtype=dt))
    if uniform:
        c = lm.init_cache(cfg, len(uniform), max_seq, layout="stacked",
                          device=dev)
        parts.append(lm.batch_prefill(
            params, cfg, torch.tensor(uniform, device=dev), c,
            frames=frames[R:], dtype=dt))
    last = torch.cat([p[0] for p in parts])
    lengths = torch.cat([p[2] for p in parts])
    cache = {key: [{k: torch.cat([p[1][key][li][k] for p in parts])
                    for k in ("k", "v")} for li in range(cfg.n_layers)]
             for key in ("layers", "cross")}
    del parts
    _sync(dev)
    t1 = time.perf_counter()
    B = last.shape[0]
    enc = torch.full((B,), cfg.encoder_seq, dtype=torch.int32, device=dev)
    fed, logits = [], [last]
    for i in range(n_new):
        tok = (last.argmax(-1) if forced is None
               else torch.as_tensor(forced[:, i], device=dev))
        fed.append(tok)
        last, cache = lm.decode_step(params, cfg, tok[:, None], cache,
                                     lengths, enc_lengths=enc, dtype=dt)
        lengths = lengths + 1
        logits.append(last)
    _sync(dev)
    t2 = time.perf_counter()
    return (torch.stack(fed, 1).cpu().numpy(),
            torch.stack(logits).float().cpu(),
            {"prefill_s": t1 - t0, "decode_s": t2 - t1})


def whisper_mp_calls(cfg, ragged_steps, n_new) -> int:
    """``mp_matmul`` launches of :func:`whisper_run` on the kernels: two
    encodes (q, k, v, out and the MLP's two a layer), two cross-cache
    fills (``cross.k``, ``cross.v`` a decoder layer), ``ragged_steps``
    replay and ``n_new`` decode steps (self q, k, v, out; cross q and out;
    the MLP's two), and one full-sequence decoder forward for the batched
    prefill (self 4, ``cross_kv``'s 2, the cross sub-block's q, k, v and
    out, the MLP's 2).  The head is tied (no MP call)."""
    L, Le = cfg.n_layers, cfg.n_encoder_layers
    return (2 * 6 * Le + 2 * 2 * L + (ragged_steps + n_new) * 8 * L
            + 12 * L)


def mp_per_call(cfg) -> int:
    """``mp_matmul`` launches of one model call: q, k, v and out of each
    attention layer, in_proj and out_proj of each RG-LRU, qkv, o_gate and
    out of each mLSTM (sLSTM's gates and a MoE's experts stay float), the
    MLP's two or three and an untied head."""
    per_kind = {"attn": 4, "local_attn": 4, "rglru": 2, "mlstm": 3,
                "slstm": 0}
    ffn = 0 if (cfg.n_experts or not cfg.d_ff) else (
        3 if cfg.activation in ("swiglu", "geglu") else 2)
    return sum(per_kind[k] + (ffn if k != "slstm" else 0)
               for k in map(cfg.block_kind, range(cfg.n_layers))) + (
        not cfg.tie_embeddings)
