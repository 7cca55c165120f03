"""Store-shard routing of a key (the reference's sharded front door).

Only ``shard_for`` lives here for now: the job controller's
``process_all(parallel=N)`` partitions a round's requests with it, so
that the requests of one job stay in one worker whatever N is. The
sharded store itself waits for the networked client.
"""

from __future__ import annotations

import zlib

#: kinds routed to shard 0 regardless of name: the lease bucket is the
#: fencing arbiter (every shard validates tokens against it), so it must
#: live in exactly one place
PINNED_KINDS = frozenset({"leases"})


def shard_for(kind: str, key: str, n_shards: int) -> int:
    """Deterministic routing: crc32 of ``kind/key`` mod N. Stable across
    processes and restarts (unlike ``hash()``, which is salted) — the
    property that lets each shard own a durable WAL lineage."""
    if n_shards <= 1 or kind in PINNED_KINDS:
        return 0
    return zlib.crc32(f"{kind}/{key}".encode()) % n_shards
