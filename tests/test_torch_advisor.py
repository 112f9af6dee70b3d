"""`DesignAdvisor.recommend` in the port against the JAX package, end to end.

* numpy backend: the recommendation is `==` the reference's numpy
  backend — configuration, cost, used bytes, plan and greedy steps — for
  every tool variant.
* torch backend on the CPU (the plain versions of the four kernels): the
  same configuration, plan and greedy steps as the reference's
  `backend="jax"` (Pallas interpret mode; run once per module), cost
  within rtol 1e-6.
* Entry points run on the card by default: without CUDA, the default
  options raise.  The port imports neither `jax` nor `repro`.
"""
import ast
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core import workload as ref_wl
from repro.core.advisor import AdvisorOptions as RefOptions
from repro.core.advisor import DesignAdvisor as RefAdvisor
from repro_torch.core import advisor as pa
from repro_torch.core import interop
from repro_torch.core.enumeration import MAX_STEPS
from torch_port_util import labels, port_workload

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def ref_workload():
    schema = ref_wl.make_tpch_like(scale=1.0, z=0.0, seed=0)
    return ref_wl.make_tpch_workload(schema, insert_weight=0.1)


@pytest.fixture(scope="module")
def workload(ref_workload):
    return port_workload(ref_workload)


@pytest.fixture(scope="module")
def budget(ref_workload):
    return 0.25 * sum(t.nrows * (sum(c.width for c in t.columns) + 4)
                      for t in ref_workload.schema.tables.values())


@pytest.fixture(scope="module")
def ref_jax_rec(ref_workload, budget):
    """The reference's jax backend (Pallas interpret mode), run once."""
    return RefAdvisor(ref_workload,
                      RefOptions(backend="jax")).recommend(budget)


def assert_same_plan(a, b):
    fa = a.estimation_plan.f if a.estimation_plan is not None else None
    fb = b.estimation_plan.f if b.estimation_plan is not None else None
    assert (fa, a.n_sampled, a.n_deduced, a.estimation_cost_pages) == \
        (fb, b.n_sampled, b.n_deduced, b.estimation_cost_pages)


VARIANTS = {
    "dtac": {},
    "dta": dict(consider_compression=False, candidate_mode="topk",
                enumeration="pure"),
    "no-deduction": dict(use_deduction=False),
    "pure": dict(enumeration="pure"),
    "density": dict(enumeration="density"),
    "topk": dict(candidate_mode="topk", topk=3),
    "tight-e": dict(e=0.1, q=0.95),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_numpy_recommend_equals_reference(ref_workload, workload, budget,
                                          variant):
    kw = VARIANTS[variant]
    want = RefAdvisor(ref_workload, RefOptions(backend="numpy", **kw)) \
        .recommend(budget)
    got = pa.DesignAdvisor(workload, pa.AdvisorOptions(backend="numpy",
                                                       **kw)) \
        .recommend(budget)
    assert labels(got.config) == labels(want.config)
    assert (got.cost, got.used_bytes, got.base_cost, got.steps) == \
        (want.cost, want.used_bytes, want.base_cost, want.steps)
    assert (got.candidate_count, got.pool_size) == \
        (want.candidate_count, want.pool_size)
    assert_same_plan(got, want)
    assert set(got.phase_seconds) == set(pa.PHASES)


@pytest.mark.parametrize("budget_frac", [0.0, 0.25])
def test_torch_cpu_recommend_equals_reference_jax(ref_workload, workload,
                                                  budget, ref_jax_rec,
                                                  budget_frac):
    if budget_frac == 0.0:
        want = RefAdvisor(ref_workload,
                          RefOptions(backend="jax")).recommend(0.0)
    else:
        want = ref_jax_rec
    got = pa.DesignAdvisor(workload, pa.AdvisorOptions(
        backend="torch", device="cpu")).recommend(budget * budget_frac / 0.25)
    assert labels(got.config) == labels(want.config)
    assert got.steps == want.steps
    assert_same_plan(got, want)
    assert math.isclose(got.cost, want.cost, rel_tol=1e-6)
    assert math.isclose(got.used_bytes, want.used_bytes, rel_tol=1e-6)
    assert set(got.phase_seconds) == set(pa.PHASES)


def test_torch_cpu_greedy_steps_equal_reference_jax_at_scale_3():
    """At scale=3 the reference's float32 jax backend runs the greedy to
    its step limit (MAX_STEPS = 64), swapping part's clustered layout
    between two LDICT layouts of equal cost, where its numpy backend stops
    after 6 steps.  The port's torch backend scores in float32 the same
    way and takes the same steps, to the same cost within rtol 1e-6."""
    schema = ref_wl.make_tpch_like(scale=3.0, z=0.0, seed=0)
    ref = ref_wl.make_tpch_workload(schema, insert_weight=0.1)
    budget = 0.25 * sum(t.nrows * (sum(c.width for c in t.columns) + 4)
                        for t in schema.tables.values())
    want = RefAdvisor(ref, RefOptions(backend="jax")).recommend(budget)
    got = pa.DesignAdvisor(port_workload(ref), pa.AdvisorOptions(
        backend="torch", device="cpu")).recommend(budget)
    assert len(want.steps) == MAX_STEPS
    assert got.steps == want.steps
    assert labels(got.config) == labels(want.config)
    assert_same_plan(got, want)
    assert math.isclose(got.cost, want.cost, rel_tol=1e-6)


def test_default_options_run_on_the_card():
    opts = dataclasses.fields(pa.AdvisorOptions)
    defaults = {f.name: f.default for f in opts}
    assert (defaults["backend"], defaults["device"]) == ("torch", "cuda")
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the defaults construct")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pa.AdvisorOptions()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pa.AdvisorOptions.dtac()


def test_invalid_options_raise():
    with pytest.raises(ValueError, match="unknown backend"):
        pa.AdvisorOptions(backend="jax", device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        pa.AdvisorOptions(backend="torch", device="meta")
    with pytest.raises(NotImplementedError, match="compression_budget"):
        pa.AdvisorOptions(backend="numpy", compression_budget=10)


def test_workload_from_spec_rejects_bad_statements(workload):
    with pytest.raises(ValueError, match="statement kind"):
        interop.workload_from_spec(workload.schema, [("delete", "x")])
    with pytest.raises(KeyError, match="unknown table"):
        interop.workload_from_spec(workload.schema,
                                   [("insert", "l", "nation", 5, 1.0)])


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "mods = sorted(m for m in sys.modules if m.startswith('repro_torch'))\n"
        "print(len(mods), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    n, bad = out.stdout.split(" ", 1)
    assert bad.strip() == "[]"
    assert int(n) >= 20


def test_chip_smoke_imports_neither_jax_nor_reference():
    tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}
