"""Physical excision of dead references — the masking comparator (port of
``repro.lifecycle.scrub``).

Deleted rows stay in place under the tombstone mask, and incident edges
are patched best effort, so an in-neighbour the dead row never knew about
keeps a stale forward lane. The hops retire such lanes positionally (PAD
in place) before anything downstream sees them.
:func:`scrub_dead_references` PADs every lane naming a tombstoned row at
that same position, so descending the scrubbed copy under an all-live mask
must equal descending the original under its mask, bitwise.
"""
from __future__ import annotations

import numpy as np

from repro_torch.types import NEG_INF, PAD_ID


def scrub_dead_references(index) -> int:
    """PAD every adjacency lane referencing a tombstoned row, in place and
    at its position (forward rows may leave by-similarity order, as the
    in-hop mask leaves them). Journals the touched rows and bumps the
    version once, so synced device copies follow; returns the number of
    lanes scrubbed. (The reference's ``resort=True`` clean-up mode has no
    caller and is not ported.)"""
    bufs = index._bufs
    n = index.n
    tomb = bufs["tombstone"][:n]
    graph_ids = bufs["graph_ids"]
    graph_sims = bufs["graph_sims"]
    rev_ids = bufs["rev_ids"]
    touched = set()
    n_scrubbed = 0
    for u in np.flatnonzero(~tomb):
        u = int(u)
        row = graph_ids[u]
        dead = (row != PAD_ID) & tomb[np.clip(row, 0, n - 1)]
        if dead.any():
            graph_ids[u][dead] = PAD_ID
            graph_sims[u][dead] = NEG_INF
            touched.add(u)
            n_scrubbed += int(dead.sum())
        rrow = rev_ids[u]
        rdead = (rrow != PAD_ID) & tomb[np.clip(rrow, 0, n - 1)]
        if rdead.any():
            rev_ids[u][rdead] = PAD_ID
            touched.add(u)
            n_scrubbed += int(rdead.sum())
    if touched:
        index.version += 1
        index._journal_rows(tuple(sorted(touched)))
    return n_scrubbed
