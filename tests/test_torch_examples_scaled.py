"""The scaled-workloads twin (`examples/torch_scaled_workloads.py`) on the
CPU against `examples/scaled_workloads.py` at 300 statements of
make_tpch_like(0.05): the same representatives, costs, certified bound,
parity lines and session counters (its own file: the CPU walk makes it
the slowest twin)."""
from test_torch_examples import assert_twin_prints_reference


def test_scaled_twin_prints_the_reference_quantities(monkeypatch):
    assert_twin_prints_reference("scaled_workloads", 0.05, 300, monkeypatch)
