"""Graphviz DOT export of a ServiceGraph.

Capability parity with the reference's exporter
(isotope/convert/pkg/graphviz/graphviz.go:59-167): one node per service
showing its type/error-rate/steps, one edge per call from the step that
makes it to the callee.
"""
from __future__ import annotations

from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.models.script import (
    ConcurrentCommand,
    RequestCommand,
    SleepCommand,
)


def _step_label(i: int, cmd) -> str:
    if isinstance(cmd, SleepCommand):
        return f"{i}: sleep {cmd}"
    if isinstance(cmd, RequestCommand):
        prob = f" ({cmd.probability}%)" if cmd.probability else ""
        return f"{i}: call {cmd.service_name} ({cmd.size}){prob}"
    if isinstance(cmd, ConcurrentCommand):
        inner = " | ".join(_step_label(i, c).split(": ", 1)[1] for c in cmd)
        return f"{i}: concurrent [{inner}]"
    return f"{i}: ?"


def _html_escape(s: str) -> str:
    return (
        s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
    )


def _dot_id(name: str) -> str:
    """Quote a node id for DOT, escaping quotes/backslashes in names."""
    escaped = name.replace("\\", "\\\\").replace('"', '\\"')
    return f'"{escaped}"'


def _node_lines(svc, indent: str) -> str:
    rows = [
        f'    <tr><td bgcolor="#9cbae8"><b>{_html_escape(svc.name)}</b>'
        f" ({svc.type.encode()}, x{svc.num_replicas})</td></tr>"
    ]
    if float(svc.error_rate):
        rows.append(
            f"    <tr><td>errorRate: {_html_escape(str(svc.error_rate))}</td></tr>"
        )
    for i, cmd in enumerate(svc.script):
        rows.append(
            f'    <tr><td port="s{i}">{_html_escape(_step_label(i, cmd))}</td></tr>'
        )
    label = (
        '<<table border="0" cellborder="1" cellspacing="0">\n'
        + "\n".join(rows)
        + "\n  </table>>"
    )
    return f"{indent}{_dot_id(svc.name)} [label={label}];"


def to_dot(graph: ServiceGraph) -> str:
    lines = [
        "digraph {",
        "  node [shape=plaintext];",
    ]
    clusters = {getattr(s, "cluster", "") for s in graph.services}
    if len(clusters) > 1:
        # multicluster topology: group nodes into DOT cluster subgraphs,
        # mirroring the reference's cluster1/cluster2 split
        # (perf/load/templates/service-graph.gen.yaml:1-3)
        for ci, cname in enumerate(sorted(clusters)):
            shown = cname or "default"
            lines.append(f'  subgraph "cluster_{ci}" {{')
            lines.append(f"    label={_dot_id(shown)};")
            for svc in graph.services:
                if getattr(svc, "cluster", "") == cname:
                    lines.append(_node_lines(svc, "    "))
            lines.append("  }")
    else:
        for svc in graph.services:
            lines.append(_node_lines(svc, "  "))
    for svc in graph.services:
        for i, cmd in enumerate(svc.script):
            for callee in _callees(cmd):
                lines.append(
                    f"  {_dot_id(svc.name)}:s{i} -> {_dot_id(callee)};"
                )
    lines.append("}")
    return "\n".join(lines) + "\n"


def _callees(cmd):
    if isinstance(cmd, RequestCommand):
        yield cmd.service_name
    elif isinstance(cmd, ConcurrentCommand):
        for sub in cmd:
            yield from _callees(sub)
