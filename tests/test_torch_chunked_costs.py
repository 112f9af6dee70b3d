"""Streamed costing (`cost_engine.chunked_config_costs`) of the port
against the JAX package's: the numpy route `==` the reference's numpy
backend bit for bit (the same chunks, the same per-chunk sums in the same
order), the torch route on the CPU within rtol 1e-6 of the reference's
jax backend, at chunk sizes of one statement, a few, and the whole
workload; empty inputs give zeros.  Each reference configuration and its
port twin are built from one label-sorted list (`torch_config_twins`), so
both iterate alike under every hash seed; a subprocess at
PYTHONHASHSEED=2 holds the bitwise comparison there."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import cost_engine as ref_ce
import repro_torch.core as pt
from torch_config_twins import port_index, twin_configs
from torch_port_util import port_schema, port_workload

CPU = torch.device("cpu")
BUDGET = 2_000_000
CHUNKS = (1, 7, 64, 8192)


def make_setup():
    ref_schema = rc.make_tpch_like(scale=0.2, z=0, seed=0)
    schema = port_schema(ref_schema)
    ref_wl = rc.make_scaled_workload(ref_schema, n_statements=300, seed=3)
    wl = port_workload(ref_wl, schema)
    adv = rc.DesignAdvisor(ref_wl, rc.AdvisorOptions.dtac())
    rec = adv.recommend(BUDGET)
    ref_configs, configs = twin_configs(
        [rc.base_configuration(ref_schema), rec.config])
    sizes = pt.SizeProvider(schema)
    for c in ref_configs:
        for i in c.indexes:
            if i.compression is not None:
                sizes.register(port_index(i), adv.sizes.size(i))
    assert any(i.compression for i in rec.config.indexes)
    return ref_wl, adv.sizes, ref_configs, wl, sizes, configs


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def check_numpy_route_bitwise(setup, chunk):
    ref_wl, ref_sizes, ref_configs, wl, sizes, configs = setup
    want = ref_ce.chunked_config_costs(ref_wl, ref_sizes, ref_configs,
                                       chunk_statements=chunk)
    got = pt.chunked_config_costs(wl, sizes, configs, chunk_statements=chunk)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_numpy_route_equals_reference_bitwise(setup, chunk):
    check_numpy_route_bitwise(setup, chunk)


def test_numpy_route_bitwise_at_hash_seed_2():
    """The four bitwise comparisons in a fresh interpreter at
    PYTHONHASHSEED=2, a seed under which configurations rebuilt by
    iterating the other package's frozenset summed in another order."""
    here = Path(__file__).resolve().parent
    path = os.pathsep.join([str(here.parent / "src"), str(here),
                            os.environ.get("PYTHONPATH", "")])
    code = ("import test_torch_chunked_costs as m\n"
            "s = m.make_setup()\n"
            "for c in m.CHUNKS:\n"
            "    m.check_numpy_route_bitwise(s, c)\n")
    env = dict(os.environ, PYTHONHASHSEED="2", PYTHONPATH=path)
    env.setdefault("JAX_PLATFORMS", "cpu")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]


@pytest.mark.parametrize("chunk", [7, 8192])
def test_torch_route_within_rtol_of_reference_jax(setup, chunk):
    ref_wl, ref_sizes, ref_configs, wl, sizes, configs = setup
    want = ref_ce.chunked_config_costs(ref_wl, ref_sizes, ref_configs,
                                       chunk_statements=chunk,
                                       backend="jax")
    got = pt.chunked_config_costs(wl, sizes, configs, chunk_statements=chunk,
                                  device=CPU)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


def test_chunks_sum_to_the_in_core_cost(setup):
    """One chunk holding the whole workload is the in-core engine's cost;
    smaller chunks differ only by the order of the partial sums."""
    _, _, _, wl, sizes, configs = setup
    whole = pt.chunked_config_costs(wl, sizes, configs,
                                    chunk_statements=len(wl.statements))
    eng = pt.CostEngine(wl, sizes)
    np.testing.assert_array_equal(whole, [eng.config_cost(c)
                                          for c in configs])
    np.testing.assert_allclose(
        pt.chunked_config_costs(wl, sizes, configs, chunk_statements=13),
        whole, rtol=1e-12)


def test_empty_inputs_give_zeros(setup):
    _, _, _, wl, sizes, configs = setup
    assert pt.chunked_config_costs(wl, sizes, []).shape == (0,)
    empty = pt.Workload(schema=wl.schema, statements=[])
    np.testing.assert_array_equal(
        pt.chunked_config_costs(empty, sizes, configs, device=CPU),
        np.zeros(len(configs)))
