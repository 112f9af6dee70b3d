"""The advisor example twins (`examples/torch_*.py`) against their
reference examples: each twin's CPU run (`--device cpu`, a small size)
prints the reference example's quantities at the same size, times aside;
the online session's replay counters aside too, because the torch
planner replays per walk where the reference's numpy planner replays per
record (the same decisions, counted differently).  Without a GPU each
twin raises unless given `--device cpu`.  The scaled-workloads twin is
held the same way in `test_torch_examples_scaled.py`."""
import re

import pytest
import torch

import repro.core as rc
from torch_port_util import EXAMPLE_TIMES, example_output, load_example

REPLAY = re.compile(r"\d+ decisions replayed, \d+ verified after group "
                    r"deltas, \d+ re-scored")
# (example, scale, statements of its main workload or None)
CASES = [("quickstart", 0.1, None), ("fleet_advisor", 0.05, None),
         ("fault_tolerant_fleet", 0.05, None),
         ("online_advisor", 0.05, 30)]
TWINS = ["quickstart", "scaled_workloads", "layout_advisor",
         "online_advisor", "fleet_advisor", "fault_tolerant_fleet",
         "serve_batched", "train_e2e"]


def quantities(text: str) -> str:
    return " ".join(REPLAY.sub("R", EXAMPLE_TIMES.sub("T", text)).split())


def assert_twin_prints_reference(name, scale, n, monkeypatch):
    ref = load_example(name)

    def small(*a, **kw):
        return rc.make_tpch_like(*a, **{**kw, "scale": scale})

    def fewer(schema, n_statements, seed=0):
        # the example's main workload only (seed 0); drift pools keep theirs
        if n is not None and seed == 0 and n_statements in (120, 10_000):
            n_statements = n
        return rc.make_scaled_workload(schema, n_statements=n_statements,
                                       seed=seed)
    monkeypatch.setattr(ref, "make_tpch_like", small)
    if hasattr(ref, "make_scaled_workload"):
        monkeypatch.setattr(ref, "make_scaled_workload", fewer)
    want = quantities(example_output(ref.main))
    args = ["--device", "cpu", "--scale", str(scale)]
    if n is not None:
        args += ["--statements", str(n)]
    got = quantities(example_output(load_example(f"torch_{name}").main,
                                    args))
    assert got == want


@pytest.mark.parametrize("name,scale,n", CASES, ids=[c[0] for c in CASES])
def test_twin_prints_the_reference_quantities(name, scale, n, monkeypatch):
    assert_twin_prints_reference(name, scale, n, monkeypatch)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA")
@pytest.mark.parametrize("name", TWINS)
def test_twin_raises_without_a_gpu(name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_example(f"torch_{name}").main([])
