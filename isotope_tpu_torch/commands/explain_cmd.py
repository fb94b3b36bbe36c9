"""``explain``: narrate WHY from a fleet's artifacts (the port of
``isotope_tpu.commands.explain_cmd``).

Fleet runs leave evidence on disk (runner/run.py): the
``isotope-fleet-blame/v1`` divergence doc (``<label>.fleet-blame.json``
— per-hop blame-share bands across members, control deltas, onset
windows), the worst member's stamped postmortem docs
(``<label>.blame.json`` / ``.timeline.json`` with the member's RNG
replay recipe), and the ``isotope-search/v1`` bracket lineage
(``<label>.search.json`` with per-rung cut lines and cost evidence).
This command turns those artifacts into a ranked "why" report —
WITHOUT re-running anything:

- fleet-blame docs render the worst members' narratives: which hop's
  blame share departed the member band, by how much vs the control
  member, and WHEN the divergence started (the recorder onset);
- search docs narrate the bracket: per rung, who was cut at what
  rank-channel value, how close the cut was, what the rung cost
  (engine traces, compile wall), and why the winner beat the
  runner-up;
- ``isotope-ingest/v1`` docs (``<label>.ingest.json``, the ``ingest``
  subcommand's fit-fidelity report) render coverage accounting,
  per-service fitted-vs-observed values, everything dropped with its
  reason, and the self-closure verdict when present.

Point it at a runner ``--out`` directory to explain every fleet in
it, or at one artifact file.
"""
from __future__ import annotations

import json
import pathlib
import sys


def register(sub) -> None:
    e = sub.add_parser(
        "explain",
        help="narrate why fleet members diverged / a search winner "
             "won, from run artifacts alone",
    )
    e.add_argument(
        "path",
        help="a runner --out directory, a <label>.fleet-blame.json, "
             "a <label>.search.json, or a <label>.ingest.json",
    )
    e.add_argument("--label", default=None,
                   help="only runs whose label contains this "
                        "substring (directory mode)")
    e.add_argument("--top", type=int, default=3,
                   help="worst members to narrate per fleet")
    e.add_argument("--hops", type=int, default=3,
                   help="hops to show per member narrative")
    e.add_argument("--json", action="store_true",
                   help="emit the collected explanation docs as JSON "
                        "instead of the report")
    e.set_defaults(func=run_explain_cmd)


def _load(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _replay_stamp(doc: dict) -> str:
    """The worst member's RNG replay recipe off a stamped postmortem
    doc (runner/run.py stamps member/member_seed/member_key)."""
    parts = [f"member {doc.get('member')}"]
    if doc.get("member_seed") is not None:
        parts.append(f"seed {doc['member_seed']}")
    if doc.get("member_key"):
        parts.append(f"key = {doc['member_key']}")
    elif doc.get("member_seed") is not None:
        parts.append("key = fold_in(cell_key, seed)")
    return ", ".join(parts)


def _fleet_section(fb_path: pathlib.Path, top: int, hops: int,
                   fleetblame) -> str:
    doc = _load(fb_path)
    label = doc.get("label") or fb_path.name.replace(
        ".fleet-blame.json", ""
    )
    lines = [f"== {label} =="]
    lines.append(fleetblame.format_report(doc, top=top, hops=hops))
    # the stamped worst-member postmortems sitting next to the fleet
    # doc carry the replay recipe
    stem = fb_path.name[: -len(".fleet-blame.json")]
    for suffix, what in (
        (".blame.json", "blame postmortem"),
        (".timeline.json", "timeline postmortem"),
        (".policies.json", "policy postmortem"),
    ):
        p = fb_path.with_name(stem + suffix)
        if not p.exists():
            continue
        d = _load(p)
        if d.get("worst_member"):
            lines.append(
                f"  replay: {p.name} pins the worst member "
                f"({_replay_stamp(d)})"
            )
    return "\n".join(lines)


def _bracket_report(doc: dict) -> str:
    """Narrate an isotope-search/v1 bracket from its lineage."""
    winner = doc["winner"]
    wid = int(winner["candidate"])
    lineage = doc.get("lineage", [])
    lines = [
        f"search bracket ({doc.get('label') or 'unlabeled'}): "
        f"{doc['candidates']} candidates -> winner {wid} "
        f"({doc['rank_effective']} severity "
        f"{winner['severity']:.6g}) in {len(lineage)} rungs, "
        f"{doc.get('traces', '?')} engine traces, mode {doc['mode']}"
    ]
    for r in lineage:
        sev = r["severity"]
        cands = r["candidates"]
        ev = r.get("evidence") or {}
        cost = ""
        if ev:
            cost = (
                f"  [traces {ev.get('traces', 0)}, compile "
                f"{ev.get('compile_s', 0.0):.2f}s]"
            )
        lines.append(
            f"rung {r['rung']}: width {r['width']} (chunk "
            f"{r['chunk']}), blocks {r['start_block']}-"
            f"{r['start_block'] + r['num_blocks']}, "
            f"{r['cum_requests']} cumulative requests{cost}"
        )
        cut = r.get("cut")
        if cut is not None:
            kept = cut["last_kept"]
            line = (
                f"  kept {cut['kept']} of {r['width']}; cut line: "
                f"candidate {kept['candidate']} "
                f"(sev {kept['severity']:.6g}) kept"
            )
            fc = cut.get("first_cut")
            if fc is not None:
                line += (
                    f" vs candidate {fc['candidate']} "
                    f"(sev {fc['severity']:.6g}) cut — margin "
                    f"{cut['margin']:.6g}"
                )
            lines.append(line)
        if wid in cands:
            row = cands.index(wid)
            rank = None
            ro = ev.get("rank_order")
            if ro is not None and wid in ro:
                rank = ro.index(wid)
            where = (
                f"ranked #{rank + 1}" if rank is not None
                else "present"
            )
            lines.append(
                f"  winner {wid} {where} (sev {sev[row]:.6g})"
            )
    # the final-rung "why": winner vs runner-up on the rank channel
    if lineage:
        last = lineage[-1]
        ro = (last.get("evidence") or {}).get("rank_order")
        if ro and len(ro) > 1:
            ru = ro[1]
            cands = last["candidates"]
            sev = last["severity"]
            try:
                gap = sev[cands.index(ru)] - sev[cands.index(wid)]
                lines.append(
                    f"why: winner {wid} beat runner-up {ru} by "
                    f"{gap:.6g} on {doc['rank_effective']} at the "
                    f"final horizon ({last['cum_requests']} requests)"
                )
            except ValueError:
                pass
    return "\n".join(lines)


def _search_section(path: pathlib.Path) -> str:
    doc = _load(path)
    if doc.get("schema") != "isotope-search/v1":
        raise ValueError(
            f"{path}: not an isotope-search/v1 document "
            f"({doc.get('schema')!r})"
        )
    label = doc.get("label") or path.name.replace(".search.json", "")
    return f"== {label} ==\n" + _bracket_report(doc)


def _ingest_section(path: pathlib.Path, top: int) -> str:
    from isotope_tpu_torch.ingest import report as ingest_report

    doc = ingest_report.load_doc(str(path))
    label = doc.get("label") or path.name.replace(".ingest.json", "")
    return f"== {label} ==\n" + ingest_report.format_report(
        doc, top=top
    )


def run_explain_cmd(args) -> int:
    # fleet-blame rendering lives with the explainer math; the import
    # is deferred so --help stays instant (commands/__init__ idiom)
    from isotope_tpu_torch.metrics import fleetblame

    root = pathlib.Path(args.path)
    fleet_docs, search_docs, ingest_docs = [], [], []
    if root.is_dir():
        match = (args.label or "")
        fleet_docs = sorted(
            p for p in root.glob("*.fleet-blame.json")
            if match in p.name
        )
        search_docs = sorted(
            p for p in root.glob("*.search.json") if match in p.name
        )
        ingest_docs = sorted(
            p for p in root.glob("*.ingest.json") if match in p.name
        )
    elif root.name.endswith(".search.json"):
        search_docs = [root]
    elif root.name.endswith(".ingest.json"):
        ingest_docs = [root]
    else:
        fleet_docs = [root]
    if not fleet_docs and not search_docs and not ingest_docs:
        print(
            f"explain: no *.fleet-blame.json, *.search.json, or "
            f"*.ingest.json under {root} — run with --attribution "
            f"over an --ensemble (or --search / ingest) first",
            file=sys.stderr,
        )
        return 1

    if args.json:
        out = {
            "fleets": [_load(p) for p in fleet_docs],
            "searches": [_load(p) for p in search_docs],
            "ingests": [_load(p) for p in ingest_docs],
        }
        json.dump(out, sys.stdout, indent=2)
        sys.stdout.write("\n")
        return 0

    sections = [
        _fleet_section(p, args.top, args.hops, fleetblame)
        for p in fleet_docs
    ]
    sections += [_search_section(p) for p in search_docs]
    sections += [_ingest_section(p, args.top) for p in ingest_docs]
    print("\n\n".join(sections))
    return 0
