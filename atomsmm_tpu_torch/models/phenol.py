"""Phenol in water (counterpart of atomsmm_tpu/models/phenol.py).

Only the bond-graph helper that the ionic-liquid builder shares is here;
the phenol builder itself belongs to the alchemy slice.
"""
from __future__ import annotations

import collections


def _pairs_within(bonds, n, max_dist):
    """{(i, j): graph distance} for every pair i < j of the n atoms that
    lies 1..max_dist bonds apart (breadth-first search per atom); `bonds`
    holds (i, j, ...) tuples."""
    adj = [[] for _ in range(n)]
    for i, j, *_ in bonds:
        adj[i].append(j)
        adj[j].append(i)
    dist = {}
    for s in range(n):
        seen = {s: 0}
        dq = collections.deque([s])
        while dq:
            u = dq.popleft()
            if seen[u] >= max_dist:
                continue
            for v in adj[u]:
                if v not in seen:
                    seen[v] = seen[u] + 1
                    dq.append(v)
        for u, d in seen.items():
            if s < u:
                dist[(s, u)] = d
    return dist
