"""Cluster resource inspection with a short cache.

Parity: reference ``ClusterResources`` (ray_cluster_resources.py:25-79) —
polls the node table at most every ``REFRESH_INTERVAL`` seconds and matches
resource requests to nodes via their ``node:<ip>`` labels.
"""

from __future__ import annotations

import time
from typing import Dict, List

from raydp_tpu_torch.cluster import api as cluster


class ClusterResources:
    REFRESH_INTERVAL = 0.1

    _last_refresh = 0.0
    _cached: List = []

    @classmethod
    def _nodes(cls) -> List:
        now = time.monotonic()
        if now - cls._last_refresh > cls.REFRESH_INTERVAL:
            cls._cached = cluster.nodes()
            cls._last_refresh = now
        return cls._cached

    @classmethod
    def total_alive_nodes(cls) -> int:
        return sum(1 for n in cls._nodes() if getattr(n, "alive", True))

    @classmethod
    def satisfy(cls, request: Dict[str, float]) -> List[str]:
        """Node labels (node:<ip>) whose resources satisfy ``request``."""
        out = []
        for node in cls._nodes():
            resources = getattr(node, "resources", {})
            if all(resources.get(k, 0.0) >= v for k, v in request.items()):
                label = next(
                    (k for k in resources if k.startswith("node:")), None
                )
                out.append(label or getattr(node, "node_id", ""))
        return out

    @classmethod
    def total_resources(cls) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for node_resources in cluster.total_resources().values():
            for k, v in node_resources.items():
                totals[k] = totals.get(k, 0.0) + v
        return totals
