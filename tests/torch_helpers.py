"""Helpers shared by the port's test files (no ``test_`` prefix, so pytest
collects nothing here)."""
import numpy as np

from repro_torch.serving import speculative


class ForcedDrafts(speculative.DraftProposer):
    """A chain proposer that drafts each request's plain greedy stream
    with every third position made wrong, so verifies accept and reject
    drafts whatever the weights."""

    def __init__(self, k, plain, vocab):
        self.k, self.plain, self.vocab = k, plain, vocab

    def propose(self, slots, cur_tok, lengths, active, caps):
        draft = np.zeros((len(slots), self.k), np.int32)
        counts = np.zeros(len(slots), np.int32)
        for b, req in enumerate(slots):
            if req is None or not active[b] or caps[b] <= 0:
                continue
            done = len(req.out)
            toks = list(self.plain[req.rid][done:done + int(caps[b])])
            for j in range(len(toks)):
                if (done + j) % 3 == 2:
                    toks[j] = (toks[j] + 1) % self.vocab
            counts[b] = len(toks)
            draft[b, :len(toks)] = toks
        return draft, counts
