"""Synthetic topology generators.

Capability parity with the reference's two generators:

- ``tree_topology``: BFS-complete trees where each service calls its
  children in ONE concurrent step (isotope/create_tree_topology.py:24-80),
  generalized so depth/branching/sizes are parameters instead of constants.
- ``realistic_topology``: scale-free Barabási-Albert graphs with the four
  archetypes from isotope/create_realistic_topology.py:55-99 — star(0.9,
  0.01), multitier(0.9, 3.25), auxiliary-services(0.05, 3.25),
  star-auxiliary(0.05, 0.01) — with edges reversed so node 0 is the source
  (:34-47), node 0 the entrypoint, and children called SEQUENTIALLY
  (:176-187). The BA process is implemented directly in numpy (nonlinear
  preferential attachment, m=1) instead of igraph.

A copy of ``isotope_tpu.models.generators`` (numpy only): the port builds
its topologies with it, e.g. the star-10k graph of ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

ARCHETYPES: Dict[str, tuple] = {
    # name -> (power, zero_appeal); create_realistic_topology.py:55-78
    "star": (0.9, 0.01),
    "multitier": (0.9, 3.25),
    "auxiliary-services": (0.05, 3.25),
    "star-auxiliary": (0.05, 0.01),
}


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


class _Fenwick:
    """Prefix-sum tree for O(log n) weighted sampling with updates —
    the nonlinear-preferential-attachment loop is O(n^2) with a dense
    weight array, which caps the generator at ~10k services; this keeps
    100k-service topologies (BASELINE configs[4]) in seconds."""

    def __init__(self, n: int):
        self.n = n
        self.tree = [0.0] * (n + 1)
        self.total = 0.0

    def add(self, i: int, delta: float) -> None:
        self.total += delta
        i += 1
        while i <= self.n:
            self.tree[i] += delta
            i += i & (-i)

    def sample(self, u: float, hi: int) -> int:
        """Index i < hi with cumweight(i-1) <= u*total < cumweight(i).

        ``hi`` bounds the attachable prefix: float accumulation drift
        (tree vs ``total`` sum the same deltas in different orders) can
        push the target a ULP past the tree sum, and the descent would
        then walk into the zero-weight suffix of not-yet-added nodes.
        """
        target = u * self.total
        idx = 0
        bit = 1 << (self.n.bit_length())
        tree = self.tree
        while bit:
            nxt = idx + bit
            if nxt <= self.n and tree[nxt] <= target:
                target -= tree[nxt]
                idx = nxt
            bit >>= 1
        return min(idx, hi - 1)


def barabasi_albert_edges(
    n: int,
    power: float,
    zero_appeal: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Nonlinear preferential attachment with m=1 (igraph Barabasi
    semantics: new node j attaches to existing i with probability
    proportional to in_degree(i)**power + zero_appeal).

    Returns an array of (source, target) pairs where source is the NEW node
    — the reference then reverses edges so node 0 becomes the root caller
    (create_realistic_topology.py:34-47); we emit caller->callee directly
    by treating the attachment target as the callee's caller, i.e. edge
    (target -> source) after reversal. Here we return (parent, child) pairs
    with parent < child, matching the reversed orientation.
    """
    if n < 1:
        raise ValueError("need at least one node")
    edges = np.empty((max(n - 1, 0), 2), dtype=np.int64)
    in_degree = np.zeros(n, dtype=np.int64)
    weights = _Fenwick(n)
    weights.add(0, zero_appeal)  # node 0: in_degree 0
    if n > 1 and zero_appeal <= 0:
        # node 0 starts with in_degree 0 => weight 0**power + 0 = 0;
        # nothing is attachable (the dense implementation hit the same
        # wall as a 0/0 in the probability normalization)
        raise ValueError(
            "zero_appeal must be positive: with no appeal an empty "
            "graph has all-zero attachment weights"
        )
    us = rng.random(max(n - 1, 0))
    for j in range(1, n):
        target = weights.sample(us[j - 1], j)
        # igraph edge j->target; reversed: target is the caller of j.
        edges[j - 1] = (target, j)
        d = in_degree[target]
        in_degree[target] = d + 1
        weights.add(target, float((d + 1) ** power - d**power))
        weights.add(j, zero_appeal)  # j becomes attachable
    return edges


def realistic_topology(
    num_services: int = 10,
    archetype: str = "multitier",
    request_size: int = 128,
    response_size: int = 128,
    num_replicas: int = 1,
    seed: int = 0,
    name_prefix: str = "mock-",
) -> dict:
    """Scale-free topology; node 0 is the entrypoint, children are called
    sequentially (one call step each, create_realistic_topology.py:176-187).
    """
    if archetype not in ARCHETYPES:
        raise ValueError(
            f"there is no graph model named as {archetype}; "
            f"try either: {sorted(ARCHETYPES)}"
        )
    power, zero_appeal = ARCHETYPES[archetype]
    rng = np.random.default_rng(seed)
    edges = barabasi_albert_edges(num_services, power, zero_appeal, rng)
    children: List[List[int]] = [[] for _ in range(num_services)]
    for parent, child in edges:
        children[int(parent)].append(int(child))
    services = []
    for i in range(num_services):
        svc: dict = {"name": f"{name_prefix}{i}"}
        if i == 0:
            svc["isEntrypoint"] = True
        if children[i]:
            svc["script"] = [
                {"call": f"{name_prefix}{c}"} for c in children[i]
            ]
        services.append(svc)
    return {
        "defaults": {
            "requestSize": request_size,
            "responseSize": response_size,
            "numReplicas": num_replicas,
        },
        "services": services,
    }


def powerlaw_topology(
    num_services: int = 100,
    exponent: float = 2.0,
    max_degree: Optional[int] = None,
    request_size: int = 128,
    response_size: int = 128,
    num_replicas: int = 1,
    seed: int = 0,
    name_prefix: str = "pl-",
    sleep_choices: Optional[List[str]] = None,
    error_rate_choices: Optional[List[str]] = None,
) -> dict:
    """Power-law (Zipf) out-degree topology: production-shaped skew.

    Real service meshes are dominated by a few high-fan-out aggregators
    over a long tail of leaf services (the Alibaba cluster-trace call
    graphs follow a Zipf out-degree law); the BA archetypes skew the
    IN-degree instead.  This generator draws an out-degree per service
    from ``Zipf(exponent)`` (minus 1, so leaves are common), sorts the
    sequence descending, and attaches BFS-style so the biggest hubs sit
    near the entrypoint — a tree with exactly ``num_services - 1``
    edges, children called SEQUENTIALLY (the ingest self-closure
    fixture relies on sequential calls: concurrent groups are only
    inferable from span traces, not from aggregate expositions).

    ``sleep_choices`` / ``error_rate_choices`` draw one per-service
    value each from the rng (e.g. ``["1ms", "4ms"]`` /
    ``["0%", "2%"]``) so fitted-vs-source residuals exercise
    heterogeneous services, not one global constant.
    """
    n = num_services
    if n < 1:
        raise ValueError("need at least one service")
    rng = np.random.default_rng(seed)
    if max_degree is None:
        max_degree = max(n // 4, 1)
    # Zipf support starts at 1; shift so degree 0 (a leaf) is common
    degrees = np.minimum(rng.zipf(exponent, size=n) - 1, max_degree)
    degrees = np.sort(degrees)[::-1]
    # BFS attachment: hand out children (hub-first) until the n-1 edge
    # budget is spent; later services keep degree 0 and stay leaves
    children: List[List[int]] = [[] for _ in range(n)]
    next_child = 1
    for i in range(n):
        want = int(degrees[i])
        take = min(want, n - next_child)
        if take <= 0:
            continue
        children[i] = list(range(next_child, next_child + take))
        next_child += take
    if next_child < n:
        # degree draw too light for the budget: chain the remainder
        # off the last placed service so the graph stays connected
        for j in range(next_child, n):
            children[j - 1].append(j)
    services = []
    for i in range(n):
        svc: dict = {"name": f"{name_prefix}{i}"}
        if i == 0:
            svc["isEntrypoint"] = True
        if error_rate_choices:
            er = error_rate_choices[int(rng.integers(
                len(error_rate_choices)
            ))]
            if er not in ("0", "0%", 0, 0.0):
                svc["errorRate"] = er
        script: List = []
        if sleep_choices:
            sl = sleep_choices[int(rng.integers(len(sleep_choices)))]
            if sl not in ("0", "0s", None):
                script.append({"sleep": sl})
        script.extend(
            {"call": f"{name_prefix}{c}"} for c in children[i]
        )
        if script:
            svc["script"] = script
        services.append(svc)
    return {
        "defaults": {
            "requestSize": request_size,
            "responseSize": response_size,
            "numReplicas": num_replicas,
        },
        "services": services,
    }


def with_call_policy(
    doc: dict,
    timeout: Optional[str] = None,
    retries: Optional[int] = None,
) -> dict:
    """Annotate every call command with a timeout and/or retry policy.

    BASELINE configs[3] — "10k-service realistic graph with
    retries/timeouts" — is a generated topology plus the reference's
    per-call policy fields (Script extension, models/script.py).  The
    generators emit bare ``{call: name}`` commands; this rewrites them
    to the object form carrying the policy, leaving everything else
    untouched.
    """

    def rewrite(cmd):
        if isinstance(cmd, list):
            return [rewrite(c) for c in cmd]
        if isinstance(cmd, dict) and "call" in cmd:
            call = cmd["call"]
            if isinstance(call, str):
                call = {"service": call}
            else:
                call = dict(call)
            if timeout is not None:
                call["timeout"] = timeout
            if retries is not None:
                call["retries"] = retries
            return {**cmd, "call": call}
        return cmd

    services = []
    for svc in doc.get("services", []):
        copy = dict(svc)
        if "script" in copy:
            copy["script"] = [rewrite(c) for c in copy["script"]]
        services.append(copy)
    out = dict(doc, services=services)
    defaults = doc.get("defaults")
    if defaults and "script" in defaults:
        out["defaults"] = dict(
            defaults, script=[rewrite(c) for c in defaults["script"]]
        )
    return out


def replicate_topology(
    doc: dict,
    instances: int,
    prefix: str = "ns",
) -> dict:
    """N disjoint copies of a topology in one graph — the shape of the
    reference's large-scale load test (perf/load/common.sh:68-90: N
    namespaces each running its own service-graph instance with its own
    load client).  Service ``svc`` of instance ``i`` becomes
    ``<prefix><i>-svc``; every instance keeps its own entrypoint, so a
    load generator can target any instance (``compile_graph(entry=...)``) or
    deploy all of them (the converter emits every service).
    """
    if instances < 1:
        raise ValueError("instances must be >= 1")
    if instances == 1:
        return doc

    def rename(name: str, i: int) -> str:
        return f"{prefix}{i}-{name}"

    def rewrite_command(cmd, i):
        if isinstance(cmd, list):
            return [rewrite_command(c, i) for c in cmd]
        if isinstance(cmd, dict) and "call" in cmd:
            call = cmd["call"]
            if isinstance(call, dict):
                call = dict(call, service=rename(call["service"], i))
            else:
                call = rename(call, i)
            return {**cmd, "call": call}
        return cmd

    # a defaults-level script would be inherited with UN-prefixed call
    # targets; materialize it per instance instead
    defaults = dict(doc.get("defaults", {}))
    default_script = defaults.pop("script", None)

    services = []
    for i in range(instances):
        for svc in doc.get("services", []):
            copy = dict(svc, name=rename(svc["name"], i))
            script = svc.get("script", default_script)
            if script is not None:
                copy["script"] = [
                    rewrite_command(c, i) for c in script
                ]
            services.append(copy)
    out = dict(doc, services=services)
    if "defaults" in doc:
        out["defaults"] = defaults
    return out
