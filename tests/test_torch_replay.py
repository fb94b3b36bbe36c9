"""The JAX engine's draws, replayed for the port, and tests of the replay.

``JaxReplayDraws`` is a draw source for ``isotope_tpu_torch``'s engine
that rebuilds, from a JAX ``PRNGKey``, exactly the random tensors the
JAX engine draws for the same block (``isotope_tpu/sim/engine.py``:
key splits and static coin elimination at 4761-4880, arrivals at 4885,
service times at 4639-4660, block keys at 4543, pilot keys at 2066).
Both engines then consume the same numbers, so their outputs can be
compared element by element.  ``test_torch_engine.py`` and
``test_torch_summary.py`` import these helpers; the tests at the end of
this file check the replay itself.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from isotope_tpu.compiler import compile_graph as jax_compile_graph
from isotope_tpu.models.graph import ServiceGraph as JaxGraph
from isotope_tpu.sim import LoadModel as JaxLoad
from isotope_tpu.sim import Simulator as JaxSimulator
from isotope_tpu_torch.compiler import compiled_from_arrays, compiled_to_arrays
from isotope_tpu_torch.sim import Simulator
from isotope_tpu_torch.sim.draws import SVC_EXPONENTIAL, SVC_NORMAL, Draws

#: float tolerance of the engine comparisons: log, ndtr, cumsum and the
#: copula matmul round differently in XLA and torch by a few ULP
RTOL = 1e-5
ATOL = 1e-9  # seconds

BOOL_FIELDS = ("hop_sent", "hop_error", "client_error", "unstable")
FLOAT_FIELDS = (
    "client_start", "client_latency", "hop_latency", "hop_start",
    "utilization",
)


class JaxReplayDraws:
    """Draw source replaying the JAX engine's streams from ``key``."""

    def __init__(self, key, jax_sim=None):
        self.key = key
        self.jax_sim = jax_sim

    def draws(self, index, spec) -> Draws:
        if self.jax_sim is not None:
            check_spec(spec, self.jax_sim)
        k = self.key if index is None else jax.random.fold_in(
            self.key, index
        )
        if spec.copula:
            (k_send, k_err, k_wait_u, k_svc, k_arr, k_wait2,
             k_wait3) = jax.random.split(k, 7)
        else:
            k_send, k_err, k_wait_u, k_svc, k_arr = jax.random.split(k, 5)
        n, h = spec.n, spec.hops

        def put(x):
            return torch.from_numpy(np.asarray(x, np.float32).copy())

        out = Draws(
            u_send=(
                put(jax.random.uniform(k_send, (n, h)))
                if spec.need_send else None
            ),
            u_err=(
                put(jax.random.uniform(k_err, (n, h)))
                if spec.need_err else None
            ),
        )
        if spec.copula:
            out = out._replace(
                z_h=put(jax.random.normal(k_wait_u, (n, h))),
                z_small=(
                    put(jax.random.normal(k_wait2, (n, spec.sib_dim)))
                    if spec.sib_dim else None
                ),
                z_call=(
                    put(jax.random.normal(k_wait3, (n, spec.retry_dim)))
                    if spec.retry_dim else None
                ),
            )
        else:
            out = out._replace(
                u_wait=put(jax.random.uniform(k_wait_u, (n, h)))
            )
        if spec.svc == SVC_EXPONENTIAL:
            out = out._replace(
                svc=put(jax.random.exponential(k_svc, (n, h)))
            )
        elif spec.svc == SVC_NORMAL:
            out = out._replace(svc=put(jax.random.normal(k_svc, (n, h))))
        if spec.arrivals:
            out = out._replace(
                arr=put(jax.random.exponential(k_arr, (n,)))
            )
        return out


def check_spec(spec, jax_sim) -> None:
    """The port asks for exactly the streams the JAX engine draws."""
    assert spec.hops == jax_sim.compiled.num_hops
    assert spec.need_send == jax_sim._need_send
    assert spec.need_err == jax_sim._need_err
    assert spec.copula == (jax_sim._copula_active or jax_sim._retry_active)
    want_sib = 0
    if jax_sim._copula_active:
        want_sib = (
            jax_sim._copula_dim
            if jax_sim._copula_mix is not None
            else jax_sim._num_sib_groups
        )
    assert spec.sib_dim == want_sib
    assert spec.retry_dim == (
        jax_sim._num_retry_groups + 1 if jax_sim._retry_active else 0
    )


def port_compiled(jax_compiled):
    """The JAX package's compiled tables, carried into the port."""
    return compiled_from_arrays(compiled_to_arrays(jax_compiled))


def assert_results_match(port_res, jax_res) -> None:
    """Booleans exactly; float fields within RTOL / ATOL."""
    for name in BOOL_FIELDS:
        got = getattr(port_res, name).cpu().numpy()
        want = np.asarray(getattr(jax_res, name))
        assert got.shape == want.shape, name
        bad = np.argwhere(got != want)
        assert bad.size == 0, f"{name} differs at {bad[:10].tolist()}"
    for name in FLOAT_FIELDS:
        got = getattr(port_res, name).cpu().numpy()
        want = np.asarray(getattr(jax_res, name))
        np.testing.assert_allclose(
            got, want, rtol=RTOL, atol=ATOL, err_msg=name
        )


# -- the replay itself ---------------------------------------------------------

# a topology that draws every stream: send coins (probability), error
# coins, the sibling copula (concurrent calls) and the retry copula
REPLAY_YAML = """
services:
- name: entry
  isEntrypoint: true
  errorRate: 2%
  script:
  - - call: {service: a, retries: 1}
    - call: {service: b, probability: 50}
- name: a
  errorRate: 5%
- name: b
"""


def _replay_pair():
    jc = jax_compile_graph(JaxGraph.from_yaml(REPLAY_YAML))
    return JaxSimulator(jc), Simulator(port_compiled(jc), device="cpu")


@pytest.mark.parametrize("kind", ["open", "closed"])
def test_replay_draws_every_stream_of_the_port_spec(kind):
    """Each stream the port asks for comes back at its shape, and the
    port's spec states the JAX engine's own coin and copula choices."""
    jax_sim, sim = _replay_pair()
    spec = sim.draw_spec(64, kind)
    assert spec.need_send and spec.need_err and spec.copula
    assert spec.sib_dim and spec.retry_dim
    draws = JaxReplayDraws(jax.random.PRNGKey(0), jax_sim).draws(7, spec)
    draws.check(spec)
    for name, t in draws._asdict().items():
        if t is not None:
            assert t.dtype == torch.float32, name
            assert bool(torch.isfinite(t).all()), name


def test_replay_folds_the_index_into_the_key():
    """Index ``None`` is the key itself; each index is its own stream,
    and the same index gives the same numbers."""
    jax_sim, sim = _replay_pair()
    spec = sim.draw_spec(32, "open")
    source = JaxReplayDraws(jax.random.PRNGKey(1), jax_sim)
    a, b, c = source.draws(None, spec), source.draws(3, spec), source.draws(
        3, spec
    )
    assert not torch.equal(a.arr, b.arr)
    for x, y in zip(b, c):
        assert (x is None and y is None) or torch.equal(x, y)


def test_replayed_arrivals_are_the_jax_engine_arrivals():
    """Open loop: the JAX run's request starts are the cumulative sum of
    the replayed unit exponentials over the rate."""
    jax_sim, sim = _replay_pair()
    key = jax.random.PRNGKey(2)
    qps = 250.0
    want = np.asarray(jax_sim.run(JaxLoad(kind="open", qps=qps), 128, key)
                      .client_start)
    arr = JaxReplayDraws(key, jax_sim).draws(
        None, sim.draw_spec(128, "open")
    ).arr
    got = torch.cumsum(arr / qps, 0).numpy()
    # cumsum association: XLA and torch may add in another order
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
