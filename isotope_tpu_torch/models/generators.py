"""Synthetic topology generators (the tree generator only).

``tree_topology`` builds BFS-complete trees where each service calls its
children in ONE concurrent step (isotope/create_tree_topology.py:24-80),
with depth, branching and sizes as parameters.  It is a copy of
``isotope_tpu.models.generators.tree_topology``; the flagship
configuration (5 levels x 3 branches, 1 KiB payloads) is built with it.
"""
from __future__ import annotations

from typing import List, Optional

def tree_topology(
    num_levels: int = 3,
    num_branches: int = 3,
    request_size: int = 128,
    response_size: int = 128,
    num_replicas: int = 1,
    sleep: Optional[str] = None,
    num_services: Optional[int] = None,
) -> dict:
    """Complete tree; each parent calls all children in one concurrent step.

    Service naming follows the reference's path scheme: root "svc-0",
    children "svc-0-0", "svc-0-1", ... (create_tree_topology.py:47-57).
    ``num_services`` caps the BFS at an exact count (the shape of the
    reference's N-svc_M-end example topologies); default is the complete
    tree.
    """
    if num_services is None:
        num_services = sum(num_branches**i for i in range(num_levels))
    services: List[dict] = []
    queue: List[tuple] = [({"name": "svc-0", "isEntrypoint": True}, ["0"])]
    while queue and len(services) < num_services:
        current, path = queue.pop(0)
        services.append(current)
        remaining = num_services - len(services) - len(queue)
        if remaining > 0:
            children = []
            for i in range(min(num_branches, remaining)):
                child_path = path + [str(i)]
                child = {"name": "svc-" + "-".join(child_path)}
                children.append(child)
                queue.append((child, child_path))
            step = [{"call": c["name"]} for c in children]
            if sleep:
                current["script"] = [{"sleep": sleep}, step]
            else:
                current["script"] = [step]
    return {
        "defaults": {
            "requestSize": request_size,
            "responseSize": response_size,
            "numReplicas": num_replicas,
        },
        "services": services,
    }
