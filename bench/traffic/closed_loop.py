"""Closed-loop traffic: each client sends its next request when its
previous one finishes.

A mix's file gives ``clients``, ``prompt_len`` and ``output_len`` (each
``[lo, hi]``, log-uniform) and ``per_client``, the length of each
client's request list (a client that reaches its end starts it again).
The lengths are a fixed schedule: a grid of log-uniform quantiles dealt
out to the clients in one fixed order, the same for every seed, because
a window sees only the first few requests of each client and runs whose
seeds dealt the sizes differently did different work (their TTFT tails
spread by 30% where two runs of one seed agreed within 4%).  The seed
draws the prompts' token ids, uniform over ``[1, vocab)``, and the
weights (``harness.weights``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _grid(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` log-uniform quantiles of ``[lo, hi]``, rounded to integers."""
    u = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
                   ).astype(np.int64)


def requests(mix: Dict, seed: int, vocab: int
             ) -> List[List[Tuple[List[int], int]]]:
    """Per client, its list of ``(prompt tokens, output length)``."""
    clients, per = int(mix["clients"]), int(mix["per_client"])
    n = clients * per
    deal = np.random.default_rng(0x5EED)  # the schedule: seed-independent
    plens = deal.permutation(_grid(*mix["prompt_len"], n))
    olens = deal.permutation(_grid(*mix["output_len"], n))
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EED])
    out = []
    for c in range(clients):
        reqs = []
        for j in range(per):
            i = c * per + j
            toks = rng.integers(1, vocab, int(plens[i])).tolist()
            reqs.append((toks, int(olens[i])))
        out.append(reqs)
    return out


class ClosedLoop:
    """Drives an engine with ``submit(prompt, max_new)``, ``tick()`` and a
    ``finished`` list: every client keeps one request in flight.
    ``client_of`` and ``max_new`` map each request id to its client and
    its drawn output length."""

    def __init__(self, engine, reqs: List[List[Tuple[List[int], int]]]):
        self.engine = engine
        self.reqs = reqs
        self.next = [0] * len(reqs)
        self.client_of: Dict[int, int] = {}
        self.max_new: Dict[int, int] = {}
        self._seen = 0
        self.emitted_done = 0  # tokens of finished requests

    def _send(self, c: int) -> None:
        prompt, max_new = self.reqs[c][self.next[c] % len(self.reqs[c])]
        self.next[c] += 1
        rid = self.engine.submit(prompt, max_new)
        self.client_of[rid] = c
        self.max_new[rid] = max_new

    def start(self) -> None:
        for c in range(len(self.reqs)):
            self._send(c)

    def tick(self) -> None:
        self.engine.tick()
        fin = self.engine.finished
        while self._seen < len(fin):
            r = fin[self._seen]
            self._seen += 1
            self.emitted_done += len(r.out)
            self._send(self.client_of[r.rid])

    def emitted(self) -> int:
        """Every token emitted so far, finished requests and live ones."""
        return self.emitted_done + sum(
            len(r.out) for r in self.engine.slots if r is not None)

    def all_started(self) -> bool:
        """True once every client's first request has its first token."""
        first = {}
        for r in self.engine.finished:
            first.setdefault(self.client_of[r.rid], True)
        for r in self.engine.slots:
            if r is not None and r.t_first is not None:
                first.setdefault(self.client_of[r.rid], True)
        return len(first) == len(self.reqs)
