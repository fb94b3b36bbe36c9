"""The census join's bytes, counted from a topology by hand."""
import math

from portbench.harness.roofline import CensusWork, peaks


def test_census_bytes_match_a_hand_count():
    doc = {
        "defaults": {"requestSize": 64, "responseSize": 64},
        "services": [
            {"name": "a", "isEntrypoint": True, "script": [
                [{"call": "b"}, {"call": "c"}],       # one step, 2 calls
                {"sleep": "1ms"},                       # a sleep step
                {"call": {"service": "d", "timeout": "1s"}},
            ]},
            {"name": "b", "errorRate": "10%", "script": [{"call": "d"}]},
            {"name": "c", "script": [{"sleep": "2ms"}]},  # sleeps alone
            {"name": "d"},
        ],
    }
    w = CensusWork({"topology": doc})
    # hops with a call: a (3 steps, a timeout: busy 4 + fail 4) and b
    # (1 step, an error rate: busy 4 + flag 1); c's sleeps are static
    assert w.bytes_per_row == 8 * (3 + 1) + (4 + 4) + (4 + 1)
    assert w.table_bytes == 8 * (3 + 1)
    assert w.ops_per_row == 4 * 4
    rows, blocks = 1000, 2
    bw, ops = peaks("NVIDIA H100 80GB HBM3")
    want = max((rows * w.bytes_per_row + blocks * w.table_bytes) / bw,
               rows * w.ops_per_row / ops)
    assert math.isclose(w.least_seconds(rows, blocks,
                                        "NVIDIA H100 80GB HBM3"), want)


def test_an_unknown_card_has_no_roofline():
    w = CensusWork({"topology": {"services": [
        {"name": "a", "isEntrypoint": True, "script": [{"call": "b"}]},
        {"name": "b"}]}})
    assert w.least_seconds(10, 1, "some other card") is None
