"""The port's canary rollouts (``isotope_tpu_torch/sim/rollout.py``,
``compile_rollouts``, the canary arm of the engine and
``Simulator.run_rollouts``) against the JAX package, draw for draw.

Stated tolerances: the controller's state and series (phase, step,
weight, promotions, holds, rollbacks, completed windows) are equal; the
per-arm arrival and error series are exact counts and the latency sums
within rtol 1e-5; the run summaries and the recorder's series as
``test_torch_policies.py`` and ``test_torch_timeline.py`` state.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.compiler import compile_policies as jax_compile_policies
from isotope_tpu.compiler import compile_rollouts as jax_compile_rollouts
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import rollout as jax_roll
from isotope_tpu_torch.compiler import (
    compile_graph,
    compile_policies,
    compile_rollouts,
)
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from isotope_tpu_torch.sim import rollout as roll_mod
from test_torch_policies import (
    _np,
    assert_policy_summary_equal,
    assert_summaries_match,
)
from test_torch_replay import JaxReplayDraws, scenario_pair
from test_torch_timeline import assert_timeline_match

KEY = jax.random.PRNGKey(0)

CHAIN = """
services:
- name: entry
  isEntrypoint: true
  numReplicas: 2
  script:
  - call: worker
- name: worker
  numReplicas: 2
"""

BAD = """
rollouts:
  defaults:
    gates: {min_samples: 20}
  worker:
    steps: [10%, 50%, 100%]
    bake: 2s
    rollback: {cooldown: 4s, max_retries: 1}
    canary: {error_rate: 30%}
"""

CLEAN = """
rollouts:
  worker:
    steps: [10%, 50%, 100%]
    bake: 2s
    gates: {min_samples: 20}
"""

KILL_COMPOSED = """
policies:
  worker:
    autoscaler: {min_replicas: 2, max_replicas: 6,
                 target_utilization: 50%, sync_period: 1s,
                 stabilization_window: 20s}
rollouts:
  worker:
    steps: [20%, 100%]
    bake: 3s
    gates: {min_samples: 20, max_error_share: 10%}
    rollback: {cooldown: 30s, max_retries: 0}
"""

ROLL_FIELDS = ("weight", "step", "phase", "promotions", "holds",
               "rollbacks", "windows_done")


def both(text):
    jg = JaxGraph.from_yaml(CHAIN + text)
    jc = jax_compile_graph(jg)
    pg = ServiceGraph.from_yaml(CHAIN + text)
    pc = compile_graph(pg)
    return (jc, jax_compile_rollouts(jg, jc), jax_compile_policies(jg, jc),
            pc, compile_rollouts(pg, pc), compile_policies(pg, pc))


def assert_rollout_summary_match(got, want):
    for name in ROLL_FIELDS:
        assert np.array_equal(_np(getattr(got, name)),
                              _np(getattr(want, name))), name
    for name in ("ver_arrivals", "ver_errors"):
        assert np.array_equal(_np(getattr(got, name)),
                              _np(getattr(want, name))), name
    np.testing.assert_allclose(_np(got.ver_latency_s),
                               _np(want.ver_latency_s), rtol=1e-5,
                               atol=1e-6)


# -- decode and tables ---------------------------------------------------------

BAD_BLOCKS = [
    {"ghost": {}},
    {"entry": {"strategy": "blue-green"}},
    {"defaults": {"steps": [0.5, 1.0]}},
    {"defaults": {"canary": {"replicas": 2}}},
    {"defaults": 3},
    {"entry": {"steps": [0.0, 1.0]}},
    {"entry": {"steps": []}},
    {"entry": {"steps": "10%"}},
    {"entry": {"rollback": {"cooldown": -1}}},
    {"entry": {"rollback": {"max_retries": -1}}},
    {"entry": {"rollback": {"after": 1}}},
    {"entry": {"gates": {"min_samples": 0}}},
    {"entry": {"gates": {"max_error_ratio": 0}}},
    {"entry": {"gates": {"p99": 1}}},
    {"entry": {"canary": {"replicas": 0}}},
    {"entry": {"canary": {"cpu_time": "0s"}}},
    {"entry": {"canary": {"image": "v2"}}},
    {"entry": 5},
    [1],
]


@pytest.mark.parametrize("raw", BAD_BLOCKS, ids=lambda r: str(r)[:40])
def test_decode_errors_match_reference(raw):
    with pytest.raises(ValueError) as want:
        jax_roll.RolloutSet.decode(raw, ["entry", "worker"])
    with pytest.raises(ValueError) as got:
        roll_mod.RolloutSet.decode(raw, ["entry", "worker"])
    assert str(got.value) == str(want.value)
    assert getattr(got.value, "config_path", None) == getattr(
        want.value, "config_path", None
    )
    assert roll_mod.lint_rollouts(raw, ["entry", "worker"]) == (
        None, [("decode", str(want.value))]
    )


@pytest.mark.parametrize("text", [BAD, CLEAN, KILL_COMPOSED, """
rollouts:
  worker:
    steps: [25%, 100%]
    canary: {replicas: 5, error_rate: 10%, cpu_time: 90us}
""", """
rollouts:
  worker:
    canary: {error_rate: 10%}
"""])
def test_compile_rollouts_tables_equal_reference(text):
    _, jt, _, _, pt, _ = both(text)
    if jt is None:
        assert pt is None
        return
    for f in jt.__dataclass_fields__:
        a, b = getattr(pt, f), getattr(jt, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(
                a, b, equal_nan=a.dtype.kind == "f"
            ), f
        else:
            assert a == b, f
    assert pt.signature() == jt.signature()
    assert (pt.k_max, pt.any_error_override, pt.any_cpu_override) == (
        jt.k_max, jt.any_error_override, jt.any_cpu_override
    )


# -- the controller law --------------------------------------------------------


def _unit_tables(mod, steps=(0.1, 0.5, 1.0), bake=2.0, min_samples=20.0,
                 cooldown=4.0, retries=1):
    rset = mod.RolloutSet(
        per_service={
            "worker": mod.ServiceRollout(
                steps=tuple(steps),
                bake_s=bake,
                gates=mod.RolloutGates.decode({"min_samples": min_samples}),
                rollback=mod.RollbackPolicy(
                    cooldown_s=cooldown, max_retries=retries
                ),
            )
        },
        defaults=mod.ServiceRollout(),
    )

    class _Svc:
        names = ("entry", "worker")
        error_rate = np.zeros(2)

    return mod.build_tables(rset, _Svc())


class _Spec:
    def __init__(self, num_windows, window_s=1.0):
        self.num_windows = num_windows
        self.window_s = window_s


def _obs(W, cnt_b=100.0, cnt_c=50.0, err_b=0.0, err_c=0.0, lat_b=0.0,
         lat_c=0.0, ref_c=0.0):
    """(2, 2, W, 4) per-window observations on the worker row: arrived
    (incl. refused), errors, latency sums, executed hops."""
    obs = np.zeros((2, 2, W, 4), np.float32)
    obs[1, 0, :, 0] = cnt_b
    obs[1, 1, :, 0] = cnt_c + ref_c
    obs[1, 0, :, 1] = err_b
    obs[1, 1, :, 1] = err_c + ref_c
    obs[1, 0, :, 2] = lat_b
    obs[1, 1, :, 2] = lat_c
    obs[1, 0, :, 3] = cnt_b
    obs[1, 1, :, 3] = cnt_c
    return obs


def _advance_both(W, ends, obs_seq, gates_off=False, **tables):
    """Advance both controllers through blocks ending at ``ends``, the
    observation accumulator of block i being ``obs_seq[i]``; states and
    deltas held equal; returns the port's state and summary."""
    jt = _unit_tables(jax_roll, **tables)
    pt = _unit_tables(roll_mod, **tables)
    if gates_off:
        off = dict(err_ratio=np.full_like(jt.err_ratio, np.inf),
                   err_share=np.full_like(jt.err_share, np.inf))
        jt = dataclasses.replace(jt, **off)
        pt = dataclasses.replace(pt, **off)
    jd, pd = jax_roll.device_tables(jt), roll_mod.device_tables(pt)
    spec = _Spec(W)
    js, ps = jax_roll.init_state(jd), roll_mod.init_state(pd)
    jacc, pacc = jax_roll.zeros_summary(spec, 2), roll_mod.zeros_summary(
        spec, 2
    )
    for t, obs in zip(ends, obs_seq):
        js, jdel = jax_roll.advance(js, jd, jnp.asarray(obs),
                                    jnp.float32(t), spec)
        ps, pdel = roll_mod.advance(ps, pd, torch.from_numpy(obs.copy()),
                                    torch.tensor(t, dtype=torch.float32),
                                    spec)
        assert ps.last_window == int(js.last_window)
        for name in jax_roll.RolloutState._fields:
            if name != "last_window":
                assert np.array_equal(_np(getattr(ps, name)),
                                      _np(getattr(js, name))), name
        assert_policy_summary_equal(pdel, jdel)
        jacc = jax_roll.accumulate_summary(jacc, jdel)
        pacc = roll_mod.accumulate_summary(pacc, pdel)
    assert_policy_summary_equal(pacc, jacc)
    return ps, pacc


def test_advance_promotes_on_clean_bake():
    obs = _obs(8)
    s, acc = _advance_both(8, [0.5, 1.0, 3.0, 8.0], [obs] * 4)
    assert acc.promotions[1].sum() == 3
    assert float(s.phase[1]) == roll_mod.PHASE_DONE
    assert float(s.weight[1]) == 1.0


def test_advance_holds_while_samples_short():
    s, acc = _advance_both(8, [8.0], [_obs(8)], min_samples=1_000.0)
    assert acc.promotions[1].sum() == 0 and acc.holds[1].sum() > 0
    assert float(s.weight[1]) == pytest.approx(0.1)


def test_advance_rolls_back_and_cools_down_then_fails():
    s, acc = _advance_both(8, [8.0], [_obs(8, err_c=20.0)])
    assert acc.rollbacks[1].tolist()[0] == 1.0
    assert acc.rollbacks[1].sum() == 2.0
    assert float(s.phase[1]) == roll_mod.PHASE_FAILED


def test_advance_latency_gate_undiluted_by_refused_calls():
    s, acc = _advance_both(
        8, [8.0], [_obs(8, lat_b=1.0, lat_c=1.5, ref_c=200.0)],
        gates_off=True, retries=0,
    )
    assert acc.rollbacks[1].sum() == 1.0
    assert float(s.phase[1]) == roll_mod.PHASE_FAILED


def test_advance_cooldown_restart_and_stale_windows():
    """A trip, then clean windows burn the cooldown and restart the
    schedule; a block that completes no new window (the same time
    again, or an earlier one) advances nothing."""
    bad, clean = _obs(4, err_c=25.0), _obs(4, cnt_c=0.0)
    s, acc = _advance_both(4, [1.0, 1.0, 0.5, 4.0],
                           [bad, bad, bad, clean], cooldown=2.0)
    assert float(s.phase[1]) == roll_mod.PHASE_ROLLING
    assert float(s.step[1]) == 0.0
    assert float(s.weight[1]) == pytest.approx(0.1)
    assert acc.windows_done.tolist() == [1.0] * 4


# -- engine co-simulation ----------------------------------------------------------


def _run_pair(text, chaos=(), n=8_000, block=1_000, qps=500.0,
              policies=False):
    jc, jt, jp, pc, pt, pp = both(text)
    js, ps = scenario_pair(
        jc, dict(timeline=True), chaos=chaos, rollouts=(jt, pt),
        policies=(jp, pp) if policies else (None, None),
    )
    load = dict(kind="open", qps=qps)
    want = js.run_rollouts(JaxLoad(**load), n, KEY, block_size=block,
                           window_s=1.0)
    got = ps.run_rollouts(LoadModel(**load), n, JaxReplayDraws(KEY, js),
                          block_size=block, window_s=1.0)
    assert len(got) == len(want)
    assert_summaries_match(got[0], want[0])
    assert_timeline_match(got[1], want[1])
    assert_rollout_summary_match(got[2], want[2])
    doc = roll_mod.to_doc(pc, got[2], pt)
    assert doc == jax_roll.to_doc(jc, want[2], jt)
    assert roll_mod.format_table(doc) == jax_roll.format_table(doc)
    return doc["services"]["worker"], got


def test_bad_canary_rolls_back_within_its_bake():
    w, (s, tl, roll) = _run_pair(BAD)
    assert w["rollbacks"] == 2.0 and w["rollback_onsets_s"][0] <= 2.0
    assert w["state"] == "failed" and w["final_weight"] == 0.0
    # the per-arm channel reconciles with the recorder's totals
    assert np.array_equal(roll.ver_arrivals.sum(1).numpy(),
                          tl.svc_arrivals.numpy().astype(np.float32))


def test_clean_canary_promotes_to_done():
    w, _ = _run_pair(CLEAN)
    assert w["state"] == "done" and w["final_weight"] == 1.0
    assert w["promotions"] == 3.0 and w["rollbacks"] == 0.0


def test_canary_kill_composes_with_policies():
    """The kill takes the canary pod first; its transport failures trip
    the error gate, the rollout reverts, and the autoscaler rides the
    same carry."""
    kill = [dict(service="worker", start_s=2.0, end_s=5.0, replicas_down=1)]
    w, got = _run_pair(KILL_COMPOSED, chaos=kill, n=10_000, block=800,
                       qps=800.0, policies=True)
    assert len(got) == 4
    assert w["rollbacks"] == 1.0 and 2.0 <= w["rollback_onsets_s"][0] <= 6.0
    assert w["state"] == "failed"
    assert float(got[3].replicas.min()) >= 0.0


def test_carrying_tables_changes_no_result():
    """Outside ``run_rollouts`` a Simulator carrying rollout tables gives
    the unrolled results on the same draws (the error coins a canary
    override arms are drawn and land below every baseline rate)."""
    jc, jt, _, pc, pt, _ = both(BAD)
    js, plain = scenario_pair(jc, dict(timeline=True))
    _, carrying = scenario_pair(jc, dict(timeline=True), rollouts=(jt, pt))
    load = LoadModel(kind="open", qps=500.0)
    a = plain.run_timeline(load, 1_000, JaxReplayDraws(KEY, js),
                           block_size=500, window_s=1.0)
    b = carrying.run_timeline(load, 1_000, JaxReplayDraws(KEY),
                              block_size=500, window_s=1.0)
    for x, y in zip(list(a[0]) + list(a[1]), list(b[0]) + list(b[1])):
        assert (x is None and y is None) or torch.equal(x, y)


def test_run_rollouts_refusals():
    _, _, _, pc, pt, _ = both(BAD)
    load = LoadModel(kind="open", qps=500.0)
    src = TorchDraws(0, "cpu")
    with pytest.raises(ValueError, match="rollout tables"):
        Simulator(pc, SimParams(timeline=True), device="cpu").run_rollouts(
            load, 256, src
        )
    with pytest.raises(ValueError, match="timeline"):
        Simulator(pc, SimParams(), rollouts=pt, device="cpu").run_rollouts(
            load, 256, src
        )
    with pytest.raises(ValueError, match="saturated"):
        Simulator(pc, SimParams(timeline=True), rollouts=pt,
                  device="cpu").run_rollouts(
            LoadModel(kind="closed", qps=None, connections=8), 256, src
        )
    from isotope_tpu_torch.sim.config import MtlsSchedule

    with pytest.raises(ValueError, match="MtlsSchedule"):
        Simulator(pc, SimParams(timeline=True), rollouts=pt,
                  mtls=MtlsSchedule(period_s=1.0, taxes_s=(0.0, 1e-3)),
                  device="cpu")


def test_canary_arm_hashes_its_own_ring_under_an_lb_law():
    """A rolled-out service under a ring hash and a wrr: the canary arm
    takes its own law's wait tables over its own replicas (reference
    engine.py:5127-5136)."""
    from isotope_tpu.compiler import compile_lb as jax_compile_lb
    from isotope_tpu_torch.compiler import compile_lb

    text = CLEAN + """
policies:
  worker:
    lb: {policy: ring_hash, hash_skew: 1.2}
  entry:
    lb: {policy: wrr, weights: [3, 1]}
"""
    jg = JaxGraph.from_yaml(CHAIN + text)
    jc = jax_compile_graph(jg)
    pg = ServiceGraph.from_yaml(CHAIN + text)
    pc = compile_graph(pg)
    js, ps = scenario_pair(
        jc, dict(timeline=True),
        lb=(jax_compile_lb(jg, jc), compile_lb(pg, pc)),
        rollouts=(jax_compile_rollouts(jg, jc), compile_rollouts(pg, pc)),
    )
    load = dict(kind="open", qps=1_500.0)
    want = js.run_rollouts(JaxLoad(**load), 4_000, KEY, block_size=1_000,
                           window_s=1.0)
    got = ps.run_rollouts(LoadModel(**load), 4_000, JaxReplayDraws(KEY, js),
                          block_size=1_000, window_s=1.0)
    assert_summaries_match(got[0], want[0])
    assert_timeline_match(got[1], want[1])
    assert_rollout_summary_match(got[2], want[2])
    assert float(got[2].ver_arrivals[:, 1].sum()) > 0  # the canary ran
