"""Index lifecycle: deletes, updates, TTL expiry, online repair (torch port
of ``repro.lifecycle``).

The index (``query/index.py``) provides the mutation primitives —
tombstoning with best-effort edge patching, fingerprint swaps, forward-row
replacement — and :class:`LifecycleManager` composes them into serving
operations scheduled between the engine's steps, so continuous plans'
in-flight slots never see a half-applied mutation:

* ``remove`` — tombstone, patch, and deregistration from routing (the
  router filters dead members at seed time);
* ``update`` — profile swap and re-linking through a descent seeded from
  the user's neighbours-of-neighbours (no routing);
* TTL expiry — rows untouched for ``ttl`` logical ticks expire in
  bounded batches;
* repair — a periodic pass re-linking survivors whose rows lost edges.

Correctness rests on the tombstone mask, which every hop (plain, fused
and DMA) applies before scoring; :func:`scrub_dead_references` is the
comparator showing masking equals physical excision.
"""
from repro_torch.lifecycle.manager import (LifecycleConfig,  # noqa: F401
                                           LifecycleManager)
from repro_torch.lifecycle.scrub import scrub_dead_references  # noqa: F401
