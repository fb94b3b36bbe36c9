"""The blame sweep of attributed runs on the CPU (``native/blame.py``).

``attribution.blame_sweep_sequential`` (the kernel's order of summation
in plain torch) is held to the op chain that ``attribute_block`` runs on
the CPU: counts, crit counts and blame histograms exactly, the float32 blame
sums within 1e-6 relative (the two sum the same float32 terms in other
orders), the residuals within RESID_ULPS float32 spacings of the block's
latency sum.  A lane-by-lane walk of the packed tables in Python, as
``csrc/blame.cu`` walks them, is held to the twin bit for bit, and to
the column map the kernel's reduction passes read.  ``launch_plan`` is
held to the geometry the kernel assumes, and the packed tables to the
per-level tables the chain reads.  The kernel itself is held to the
twin on the card by ``tests/test_torch_blame_cuda.py`` and by
``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

from isotope_tpu_torch.compiler import compile_graph
from isotope_tpu_torch.metrics import attribution
from isotope_tpu_torch.models.generators import (
    realistic_topology,
    tree_topology,
)
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.native import blame
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from isotope_tpu_torch.sim.config import ChaosEvent

COUNTS = ("count", "tail_count", "crit_count", "error_count",
          "tail_crit_count", "hist", "tail_hist")
SECONDS = blame.FIELDS[:8]
#: the twin against the chain: the same float32 terms summed in other
#: orders (a pairwise tree a tile, then tiles and groups in sequence,
#: against torch's reductions)
RTOL = 1e-6
#: float32 spacings of the block's latency sum the residuals may differ by
RESID_ULPS = 16

RETRY_YAML = """
services:
- name: entry
  isEntrypoint: true
  errorRate: 2%
  script:
  - call: {service: mid, timeout: 400us, retries: 2}
  - sleep: 1ms
- name: mid
  errorRate: 5%
  numReplicas: 2
  script:
  - - call: {service: leaf, probability: 60}
    - call: leaf2
  - call: {service: leaf, timeout: 2ms}
- name: leaf
- name: leaf2
"""


def tree121():
    return ServiceGraph.decode(tree_topology(
        num_levels=5, num_branches=3, request_size=1024, response_size=1024,
    ))


def retry_sim():
    """Retries (masked attempts), timeouts (capped), a sleep floor, a
    sequential second call, errors and a killed leaf."""
    return Simulator(
        compile_graph(ServiceGraph.from_yaml(RETRY_YAML)),
        SimParams(attribution=True),
        (ChaosEvent("leaf2", 0.2, 0.6, replicas_down=None, drain=False),),
        device="cpu",
    )


def tree_sim():
    return Simulator(compile_graph(tree121()), SimParams(attribution=True),
                     device="cpu")


# (name, simulator, qps, rows a member, members)
CASES = {
    "tree121": (tree_sim, 1e4, 4096, 0),
    "retries-timeouts": (retry_sim, 2000.0, 3000, 0),
    "fleet-m4": (tree_sim, 1e4, 1024, 4),
}


@pytest.fixture(scope="module")
def blocks():
    """Each case's Simulator and one block of its results on the CPU (a
    fleet's: M members' blocks, member-major, as the fold lays them)."""
    out = {}
    for name, (make, qps, rows, members) in CASES.items():
        sim = make()
        res = sim.run(LoadModel(kind="open", qps=qps),
                      rows * max(members, 1), TorchDraws(3, "cpu"))
        out[name] = (sim, res, members)
    return out


def _cut(res):
    return float(np.quantile(res.client_latency.numpy(), 0.9))


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("tail", [False, True], ids=["mean", "tail"])
@pytest.mark.parametrize("case", list(CASES))
def test_sequential_matches_the_chain(blocks, case, tail):
    sim, res, members = blocks[case]
    tables = sim._attribution_tables()
    cut = _cut(res) if tail else None
    want, _ = attribution.attribute_block(res, tables, tail_cut=cut,
                                          members=members)
    got = attribution.blame_sweep_sequential(res, tables, tail_cut=cut,
                                             members=members)
    for name in COUNTS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(got.crit_count.sum()) > 0
    if tail:
        assert int(got.tail_count.sum()) > 0
    for name in SECONDS:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name).numpy(), rtol=RTOL,
                                   atol=0.0, err_msg=name)
    assert torch.equal(got.tail_cut, want.tail_cut)
    bound = RESID_ULPS * float(np.spacing(np.float32(
        res.client_latency.sum())))
    for name in ("residual", "residual_abs"):
        d = (getattr(got, name) - getattr(want, name)).abs().max()
        assert float(d) <= bound, name
    if case == "retries-timeouts":
        assert float(got.timeout_blame.sum()) > 0
        assert int(got.error_count.sum()) > 0


def test_sequential_accumulates_like_accumulate(blocks):
    """``acc`` is added to as ``attribution.accumulate`` adds."""
    sim, res, _ = blocks["retries-timeouts"]
    tables = sim._attribution_tables()
    cut = _cut(res)
    one = attribution.blame_sweep_sequential(res, tables, tail_cut=cut)
    two = attribution.blame_sweep_sequential(res, tables, tail_cut=cut,
                                             acc=one)
    want = attribution.accumulate(one, one)
    for name in COUNTS + SECONDS + ("residual", "residual_abs",
                                     "tail_cut"):
        assert _same_bits(getattr(two, name), getattr(want, name)), name


# -- the kernel's walk, lane by lane -------------------------------------------


def _f(x):
    return np.float32(x)


def _bits(i):
    """The float32 whose bits are the int32 ``i``."""
    return np.int32(i).view(np.float32)


def _kernel_walk(res, tables, tail_cut, members):
    """``csrc/blame.cu``'s sweep in Python: each row's walk of the slot
    and attempt records, the tiles' pairwise trees and the two reduction
    passes, into a new accumulator (``attribution.accumulator``'s layout,
    as numpy)."""
    sw = tables.sweep
    lo = sw.level_offset.tolist()
    lvl_to = sw.level_timeout.tolist()
    slot_ptr = sw.slot_ptr.tolist()
    slots = [(e0, e1, _bits(base)) for e0, e1, base, _ in sw.slots.tolist()]
    recs = [(c, _bits(rtt), _bits(tmo), flags)
            for c, rtt, tmo, flags in sw.attempts.tolist()]
    hop_bin, col_map = sw.hop_bin.tolist(), sw.col_map.tolist()
    lat, wait = res.hop_latency.numpy(), res.hop_wait.numpy()
    sent, err = res.hop_sent.numpy(), res.hop_error.numpy()
    client = res.client_latency.numpy()
    n, h = lat.shape
    mp = max(members, 1)
    rows = n // mp
    s_n = tables.num_services
    nb = s_n * blame.BUCKETS
    cut = _f(tail_cut) if tail_cut is not None else None
    ncols = len(col_map)
    hist = np.zeros(2 * mp * nb, np.int64)

    def bucket(c):
        c = c if math.isnan(c) else max(c, _f(0.0))
        lg = math.log(float(c)) if c > 0 else -math.inf
        t = (lg - attribution._B_LOG_LO) * attribution._B_INV_LOG_R
        if math.isnan(t):
            return blame.BUCKETS - 1
        return int(math.floor(min(max(t, -1.0), blame.BUCKETS - 2))) + 1

    def walk(row, m):
        """One row's columns by code (float32 values, counts 0 / 1)."""
        out = {}

        def put(f, hop, *v):
            for i, x in enumerate(v):
                out[(f[i] << blame.FIELD_SHIFT) | hop] = x
        cl = client[row]
        tw = _f(1.0) if cut is not None and cl >= cut else _f(0.0)
        net0 = _f(tables.root_net if sent[row, 0] else tables.refused_net)
        per_req = float(net0)
        put((blame.F_NET, blame.F_TNET), 0, net0, _f(net0 * tw))
        w = {0: _f(1.0) if sent[row, 0] else _f(0.0)}
        for d in range(len(lo) - 1):
            has_to = bool(lvl_to[d])
            nxt = {}
            s_net = s_tmo = s_con = 0.0   # float64, as the kernel's
            for p in range(lo[d], lo[d + 1]):
                wp = w.get(p, _f(0.0))
                dsum = 0.0
                for s in range(slot_ptr[p], slot_ptr[p + 1]):
                    e0, e1, base = slots[s]

                    def att(c, rtt, tmo):
                        raw = _f(rtt + lat[row, c])
                        cap = min(raw, tmo) if has_to else raw
                        return raw, _f(_f(sent[row, c]) * cap)

                    mx, win, k, dur = _f(0.0), -1, 0, _f(0.0)
                    for c, rtt, tmo, flags in recs[e0:e1]:
                        ad = att(c, rtt, tmo)[1]
                        dur = ad if flags & blame.FIRST_ATTEMPT \
                            else _f(dur + ad)
                        if not flags & blame.LAST_ATTEMPT:
                            continue
                        if dur > mx:
                            mx, win = dur, k
                        elif dur == mx and win < 0:
                            win = k
                        k += 1
                    beats = mx >= base
                    k = 0
                    for c, rtt, tmo, flags in recs[e0:e1]:
                        wk = _f(wp * _f(k == win and beats))
                        k += bool(flags & blame.LAST_ATTEMPT)
                        raw, ad = att(c, rtt, tmo)
                        on = _f(wk * _f(sent[row, c]))
                        capped = has_to and raw > tmo
                        dsum += float(_f(on * ad))
                        wn = _f(on * _f(not capped)) if has_to else on
                        nxt[c] = wn
                        net = _f(wn * rtt)
                        tmc = (_f(_f(on * _f(capped)) * ad) if has_to
                               else _f(0.0))
                        s_net, s_tmo = s_net + float(net), s_tmo + float(tmc)
                        put((blame.F_NET, blame.F_TNET), c, net,
                            _f(net * tw))
                        if has_to:
                            put((blame.F_TIMEOUT, blame.F_TTIMEOUT), c,
                                tmc, _f(tmc * tw))
                dp = _f(dsum)
                hw = _f(wp * wait[row, p])
                hs = _f(_f(wp * _f(lat[row, p] - wait[row, p])) - dp)
                con = _f(hw + hs)
                s_con = s_con + float(con)
                put((blame.F_WAIT, blame.F_SELF, blame.F_TWAIT,
                     blame.F_TSELF, blame.F_CRIT, blame.F_TCRIT,
                     blame.F_ERROR), p, hw, hs, _f(hw * tw), _f(hs * tw),
                    int(wp != 0), int(_f(wp * tw) != 0),
                    int(sent[row, p] and err[row, p]))
                if wp != 0:
                    b = m * nb + hop_bin[p] + bucket(con)
                    hist[b] += 1
                    hist[mp * nb + b] += int(_f(wp * tw) != 0)
            per_req = ((per_req + s_net) + s_tmo) + s_con
            w = nxt
        res_ = _f(float(cl) - per_req)
        put((blame.F_RESIDUAL, blame.F_RESIDUAL_ABS, blame.F_TAIL_COUNT), 0,
            res_, abs(res_), int(tw != 0))
        assert sorted(out) == sorted(col_map)
        return out

    is_count = [(c >> blame.FIELD_SHIFT) >= blame.F_CRIT for c in col_map]
    tiles = -(-rows // blame.TILE)
    groups = -(-tiles // blame.FOLD_GROUP)
    lay, nf, ni = attribution._acc_layout(members, h, s_n)
    accf, acci = np.zeros(nf, np.float32), np.zeros(ni, np.int64)
    for m in range(mp):
        tile_sums, tails = [], []
        for t in range(tiles):
            tile = blame.TILE
            walks = [walk(m * rows + r, m) if r < rows else None
                     for r in range(t * tile, t * tile + tile)]
            # a tile writes its tail columns only with a row past the cut
            tails.append(cut is not None and any(
                client[m * rows + r] >= cut
                for r in range(t * tile, min(t * tile + tile, rows))))
            sums = []
            for j in range(ncols):
                v = [x[col_map[j]] if x is not None else 0 for x in walks]
                if is_count[j]:
                    sums.append(sum(v))
                    continue
                v = [_f(x) for x in v]
                while len(v) > 1:
                    v = [_f(v[i] + v[i + 1]) for i in range(0, len(v), 2)]
                sums.append(v[0])
            tile_sums.append(sums)
        for j in range(ncols):
            code = col_map[j]
            f, hop = code >> blame.FIELD_SHIFT, code & ((1 << 27) - 1)
            total = 0 if is_count[j] else _f(0.0)
            for g in range(groups):
                part = 0 if is_count[j] else _f(0.0)
                for t in range(g * 64, min(g * 64 + 64, tiles)):
                    if j >= sw.main_cols and not tails[t]:
                        continue
                    part = (part + tile_sums[t][j] if is_count[j]
                            else _f(part + tile_sums[t][j]))
                total = total + part if is_count[j] else _f(total + part)
            name = blame.FIELDS[f]
            _, base, length, _ = lay[name]
            idx = base + m * length + (hop if length > 1 else 0)
            if is_count[j]:
                acci[idx] += total
            else:
                accf[idx] = _f(accf[idx] + total)
        acci[lay["count"][1] + m] += rows
        accf[lay["tail_cut"][1] + m] = cut if cut is not None else np.inf
    acci[lay["hist"][1]:] += hist
    return accf, acci


@pytest.mark.parametrize("members", [0, 2])
@pytest.mark.parametrize("tail", [False, True], ids=["mean", "tail"])
def test_kernel_walk_equals_sequential(members, tail):
    """The kernel's walk of the packed tables, its columns and its
    passes give the twin's bits (small blocks: 70 rows a member, a
    ragged last tile)."""
    sim = retry_sim()
    res = sim.run(LoadModel(kind="open", qps=2000.0),
                  70 * max(members, 1), TorchDraws(5, "cpu"))
    tables = sim._attribution_tables()
    cut = _cut(res) if tail else None
    accf, acci = _kernel_walk(res, tables, cut, members)
    want = attribution.blame_sweep_sequential(
        res, tables, tail_cut=cut, members=members,
        acc=attribution.accumulator(members, tables.num_hops,
                                    tables.num_services, "cpu"))
    lay, _, _ = attribution._acc_layout(members, tables.num_hops,
                                        tables.num_services)
    mp = max(members, 1)
    for name, (b, off, length, _) in lay.items():
        got = torch.as_tensor((accf if b == "f" else acci)[
            off:off + mp * length])
        w = getattr(want, name).reshape(-1)
        assert _same_bits(got, w), name


# -- the packed tables ---------------------------------------------------------


TOPOLOGIES = {
    "tree121": tree121,
    "retries-timeouts": lambda: ServiceGraph.from_yaml(RETRY_YAML),
    "canonical": lambda: ServiceGraph.from_yaml_file(
        "examples/topologies/canonical.yaml"),
    "realistic-powerlaw-100": lambda: ServiceGraph.from_yaml_file(
        "examples/topologies/realistic-powerlaw-100.yaml"),
    "multitier-300": lambda: ServiceGraph.decode(realistic_topology(
        300, archetype="multitier", seed=0)),
}


def _records(sw):
    """The packed tables as Python: each hop's slots (first attempt, end,
    sleep floor) and each attempt's (hop, wire time, timeout, flags)."""
    slot_ptr = sw.slot_ptr.tolist()
    slots = [(e0, e1, float(_bits(b))) for e0, e1, b, _ in sw.slots.tolist()]
    recs = [(c, float(_bits(r)), float(_bits(t)), f)
            for c, r, t, f in sw.attempts.tolist()]
    return slot_ptr, slots, recs


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_packed_tables_match_the_level_tables(topo):
    """The slot and attempt records give each level's parents, slots,
    calls, attempts, masks, sleep floors, wire times, timeouts and
    service bins as the per-level tables do, and walk each level's
    children in their order."""
    compiled = compile_graph(TOPOLOGIES[topo]())
    tables = attribution.build_tables(compiled, SimParams().network)
    sw = tables.sweep
    lo = sw.level_offset.tolist()
    slot_ptr, slots, recs = _records(sw)
    assert lo == [lv.offset for lv in tables.levels] + [compiled.num_hops]
    assert sw.widest == max(lv.size for lv in tables.levels)
    assert [s[0] for s in slots[1:]] == [s[1] for s in slots[:-1]]
    for d, lv in enumerate(tables.levels):
        h0, h1 = lo[d], lo[d + 1]
        assert torch.equal(sw.hop_bin[h0:h1].long(), lv.svc_base)
        assert sw.level_timeout[d].item() == int(lv.has_timeout)
        s0, s1 = slot_ptr[h0], slot_ptr[h1]
        if not lv.child_size:
            assert s0 == s1
            continue
        assert s1 - s0 == lv.n_slots
        assert [s[2] for s in slots[s0:s1]] == lv.slot_base.tolist()
        slot_of_call = lv.slot_of_call.numpy()
        call_of_child = lv.call_of_child.numpy()
        kids = []
        for h in range(h0, h1):
            for s in range(slot_ptr[h], slot_ptr[h + 1]):
                e0, e1, _ = slots[s]
                calls = np.flatnonzero(slot_of_call == s - s0)
                got, call = [], []
                for c, rtt, tmo, flags in recs[e0:e1]:
                    if flags & blame.FIRST_ATTEMPT:
                        call = []
                    call.append(c - h1)
                    assert rtt == float(lv.child_rtt[c - h1])
                    assert tmo == float(lv.child_timeout[c - h1])
                    assert lv.parent_local[c - h1] == h - h0
                    if flags & blame.LAST_ATTEMPT:
                        got.append(call)
                assert len(got) == len(calls)
                for att, ck in zip(got, calls):
                    chain = [int(lv.att_child[a][ck])
                             for a in range(len(lv.att_child))
                             if lv.att_mask[a] is None or lv.att_mask[a][ck]]
                    assert att == chain
                    assert all(call_of_child[c] == ck for c in att)
                    kids += att
        # the kernel's order of the level's children is the chain's
        assert kids == list(range(lv.child_size))


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_column_map_is_the_kernels_walk(topo):
    """Each (field, hop) once, in the order the kernel's walk emits
    them: the main stream, then the tail stream; timeouts only for the
    attempts of levels with one."""
    compiled = compile_graph(TOPOLOGIES[topo]())
    sw = attribution.build_tables(compiled, SimParams().network).sweep
    h = compiled.num_hops
    lo = sw.level_offset.tolist()
    timed = sw.level_timeout.tolist()
    slot_ptr, slots, recs = _records(sw)

    def code(f, hop=0):
        return f << blame.FIELD_SHIFT | hop

    def stream(net, tmo, own):
        out = [code(net)]
        for d in range(len(lo) - 1):
            for p in range(lo[d], lo[d + 1]):
                for s in range(slot_ptr[p], slot_ptr[p + 1]):
                    for c, _, _, _ in recs[slots[s][0]:slots[s][1]]:
                        out.append(code(net, c))
                        if timed[d]:
                            out.append(code(tmo, c))
                out += [code(f, p) for f in own]
        return out

    main = stream(blame.F_NET, blame.F_TIMEOUT, (
        blame.F_WAIT, blame.F_SELF, blame.F_CRIT, blame.F_ERROR))
    main += [code(blame.F_RESIDUAL), code(blame.F_RESIDUAL_ABS),
             code(blame.F_TAIL_COUNT)]
    tail = stream(blame.F_TNET, blame.F_TTIMEOUT, (
        blame.F_TWAIT, blame.F_TSELF, blame.F_TCRIT))
    assert sw.col_map.tolist() == main + tail
    assert sw.main_cols == len(main)
    assert len(set(main + tail)) == len(main + tail)
    if not any(timed):
        assert sw.num_cols == 9 * h + 3
    else:
        assert sw.num_cols > 9 * h + 3


# -- the launch plan -------------------------------------------------------------


# (name, rows a member, members, hops, widest level)
PLANS = [
    ("tree121", 262_144, 0, 121, 81),
    ("tree121-pilot", 8_192, 0, 121, 81),
    ("canonical", 16_384, 0, 6, 3),
    ("star10k", 3_355, 0, 10_000, 5_021),
    ("svc100k", 1_024, 0, 100_000, 13_026),
    ("1000-svc_2000-end", 2_048, 0, 120_000, 60_021),
    ("ensembleN-observed", 8_192, 8, 121, 81),
    ("fleet32", 65_536, 32, 13, 9),
    ("one-row", 1, 0, 3, 2),
]


@pytest.mark.parametrize("name,rows,members,hops,widest", PLANS,
                         ids=[p[0] for p in PLANS])
def test_launch_plan_geometry(name, rows, members, hops, widest):
    plan = blame.launch_plan(rows, members, hops, widest)
    mp = max(members, 1)
    bits = 2 * plan.words * blame.TILE * 4
    per_warp = blame.WINDOW_BYTES + blame.COLUMN_BYTES + (
        0 if plan.global_bits else bits)
    # the widest level's bits fit each lane, in shared memory where one
    # warp's do, else in device memory within its budget
    assert plan.words * 32 >= widest > (plan.words - 1) * 32
    assert plan.global_bits == (
        bits + blame.WINDOW_BYTES + blame.COLUMN_BYTES > blame.SMEM_BLOCK)
    assert plan.bits_bytes <= blame.BITS_DEVICE_MAX
    assert 1 <= plan.warps <= blame.MAX_WARPS
    assert plan.smem_bytes == plan.warps * per_warp <= blame.SMEM_BLOCK
    assert plan.tiles * blame.TILE >= rows > (plan.tiles - 1) * blame.TILE
    assert plan.groups == -(-plan.tiles // blame.FOLD_GROUP)
    assert 1 <= plan.ctas <= blame.H100_SMS * 8
    assert plan.ctas * plan.warps <= max(mp * plan.tiles, plan.warps) + \
        plan.warps
    # the SM count moves only how many blocks run, never the sums
    other = blame.launch_plan(rows, members, hops, widest, 78)
    assert (other.tiles, other.groups, other.fold_group, other.warps,
            other.smem_bytes) == (plan.tiles, plan.groups, plan.fold_group,
                                  plan.warps, plan.smem_bytes)


def test_launch_plan_puts_wide_levels_in_device_memory():
    """A level too wide for a warp's shared memory keeps its crit bits
    in device memory, and fewer warps run."""
    narrow = blame.launch_plan(262_144, 0, 121, 81)
    wide = blame.launch_plan(262_144, 0, 120_000, 60_021)
    assert not narrow.global_bits and narrow.bits_bytes == 0
    assert wide.global_bits
    assert 0 < wide.bits_bytes <= blame.BITS_DEVICE_MAX
    assert wide.ctas * wide.warps < narrow.ctas * narrow.warps


def test_launch_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        blame.launch_plan(1024, 0, 30_000_000, 20_000_000)
    with pytest.raises(ValueError, match="no plan"):
        blame.launch_plan(1024, 0, 0, 1)


# -- the CUDA entry point on the CPU ---------------------------------------------


def test_attribute_block_runs_the_chain_on_the_cpu(blocks, monkeypatch):
    """On a CPU tensor ``attribute_block`` is the chain plus
    ``accumulate``: the kernel's wrapper is never called."""
    sim, res, _ = blocks["tree121"]
    tables = sim._attribution_tables()

    def refuse(*a, **k):
        raise AssertionError("blame_sweep called on the CPU")

    monkeypatch.setattr(blame, "blame_sweep", refuse)
    one, _ = attribution.attribute_block(res, tables)
    two, _ = attribution.attribute_block(res, tables, acc=one)
    assert torch.equal(two.crit_count, 2 * one.crit_count)


def test_blame_sweep_refuses_cpu_tensors(blocks):
    sim, res, _ = blocks["tree121"]
    tables = sim._attribution_tables()
    shape = (0, tables.num_hops, tables.num_services)
    acc = attribution.accumulator(*shape, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        blame.blame_sweep(res, tables, *attribution._acc_buffers(
            acc, *shape, torch.device("cpu")))


def test_accumulator_layout():
    """A new accumulator's fields are contiguous views of two buffers,
    zero, with the tail cut at -inf; the buffers are the whole of
    them."""
    acc = attribution.accumulator(3, 7, 5, "cpu")
    assert acc.wait_blame.shape == (3, 7) and acc.hist.shape == (3, 5, 64)
    assert acc.count.shape == (3,) and acc.exemplars is None
    assert float(acc.tail_cut.max()) == -np.inf
    for name in COUNTS + SECONDS + ("residual", "residual_abs"):
        x = getattr(acc, name)
        assert x.is_contiguous() and int(x.count_nonzero()) == 0, name
    _, nf, ni = attribution._acc_layout(3, 7, 5)
    accf, acci = attribution._acc_buffers(acc, 3, 7, 5, torch.device("cpu"))
    assert accf.shape == (nf,) and acci.shape == (ni,)
    assert accf.data_ptr() == acc.wait_blame.data_ptr()
    assert acci[-1].data_ptr() == acc.tail_hist[-1, -1, -1].data_ptr()
    with pytest.raises(ValueError, match="not a view"):
        attribution._acc_buffers(acc._replace(hist=acc.hist.clone()), 3,
                                 7, 5, torch.device("cpu"))


@pytest.mark.parametrize("tail", [False, True], ids=["mean", "tail"])
def test_a_new_accumulator_takes_the_first_block(blocks, tail):
    """Adding a block to a new accumulator gives the block's own sums,
    counts and tail cut (``max`` of -inf and the cut), as a run's first
    block takes them."""
    sim, res, members = blocks["fleet-m4"]
    tables = sim._attribution_tables()
    cut = _cut(res) if tail else None
    alone = attribution.blame_sweep_sequential(res, tables, tail_cut=cut,
                                               members=members)
    into = attribution.blame_sweep_sequential(
        res, tables, tail_cut=cut, members=members,
        acc=attribution.accumulator(members, tables.num_hops,
                                    tables.num_services, "cpu"))
    for name in COUNTS + SECONDS + ("residual", "residual_abs",
                                     "tail_cut"):
        assert torch.equal(getattr(into, name), getattr(alone, name)), name
