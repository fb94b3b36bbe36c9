"""The port's copy of the topology generators against the JAX package's.

``isotope_tpu_torch/models/generators.py`` copies
``isotope_tpu/models/generators.py`` (numpy only): every generator must
return the same topology document for the same arguments.
``chip_smoke.py`` builds the 10,000-service star graph with it.
"""
import numpy as np
import pytest

from isotope_tpu.models import generators as jax_gen
from isotope_tpu_torch.models import generators as gen


@pytest.mark.parametrize("archetype", sorted(jax_gen.ARCHETYPES))
def test_realistic_topology_matches_reference(archetype):
    assert gen.realistic_topology(300, archetype=archetype, seed=3) == (
        jax_gen.realistic_topology(300, archetype=archetype, seed=3)
    )


def test_star10k_with_timeouts_matches_reference():
    """BASELINE configs[3]: the 10k realistic star graph, 30 s timeouts."""
    got = gen.with_call_policy(
        gen.realistic_topology(10_000, archetype="star", seed=0),
        timeout="30s",
    )
    assert got == jax_gen.with_call_policy(
        jax_gen.realistic_topology(10_000, archetype="star", seed=0),
        timeout="30s",
    )
    assert len(got["services"]) == 10_000


def test_barabasi_albert_edges_match_reference():
    for power, zero_appeal in jax_gen.ARCHETYPES.values():
        np.testing.assert_array_equal(
            gen.barabasi_albert_edges(
                500, power, zero_appeal, np.random.default_rng(1)
            ),
            jax_gen.barabasi_albert_edges(
                500, power, zero_appeal, np.random.default_rng(1)
            ),
        )


@pytest.mark.parametrize("kwargs", [
    dict(num_services=100, seed=0),
    dict(num_services=300, exponent=2.5, max_degree=20, seed=4,
         sleep_choices=["1ms", "5ms"], error_rate_choices=["0%", "1%"]),
])
def test_powerlaw_topology_matches_reference(kwargs):
    assert gen.powerlaw_topology(**kwargs) == jax_gen.powerlaw_topology(
        **kwargs
    )


def test_call_policy_and_replicas_match_reference():
    doc = gen.tree_topology(3, 3)
    for kw in (dict(timeout="1s"), dict(retries=2),
               dict(timeout="250ms", retries=1)):
        assert gen.with_call_policy(doc, **kw) == jax_gen.with_call_policy(
            doc, **kw
        )
    assert gen.replicate_topology(doc, 3) == jax_gen.replicate_topology(
        doc, 3
    )
