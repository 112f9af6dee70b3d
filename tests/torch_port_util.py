"""Shared helpers of the tests that hold the PyTorch port (`repro_torch`)
against the JAX package (`repro`): hand the reference's exact schema and
workload to the port as plain data, and compare configurations of the
two packages by their index labels."""
import numpy as np

import repro_torch.core as pt


def port_schema(ref_schema) -> "pt.Schema":
    tables = {name: ([(c.name, c.width) for c in t.columns], t.values)
              for name, t in ref_schema.tables.items()}
    fks = [(fk.fact_table, fk.fk_col, fk.dim_table, fk.dim_key)
           for fk in ref_schema.foreign_keys]
    return pt.schema_from_arrays(tables, fks)


def port_workload(ref_workload, schema=None) -> "pt.Workload":
    schema = schema if schema is not None else \
        port_schema(ref_workload.schema)
    spec = []
    for s in ref_workload.statements:
        if hasattr(s, "filters"):
            spec.append(("query", s.name, s.table,
                         [(p.col, p.lo, p.hi) for p in s.filters],
                         list(s.cols_used), s.weight))
        else:
            spec.append(("insert", s.name, s.table, s.nrows, s.weight))
    return pt.workload_from_spec(schema, spec)


def labels(config) -> list:
    return sorted(i.label() for i in config.indexes)


def tables_equal(ref_schema, port_schema_) -> bool:
    if list(ref_schema.tables) != list(port_schema_.tables):
        return False
    for name, t in ref_schema.tables.items():
        p = port_schema_.tables[name]
        if [(c.name, c.width) for c in t.columns] != \
                [(c.name, c.width) for c in p.columns]:
            return False
        if not all(np.array_equal(t.values[c.name], p.values[c.name])
                   for c in t.columns):
            return False
    return True


def statement_spec(s) -> tuple:
    """A statement of either package as plain data."""
    if hasattr(s, "filters"):
        return ("query", s.name, s.table,
                tuple((p.col, int(p.lo), int(p.hi)) for p in s.filters),
                tuple(s.cols_used), float(s.weight))
    return ("insert", s.name, s.table, int(s.nrows), float(s.weight))


def port_config(ref_config) -> "pt.Configuration":
    """The port's Configuration of a reference configuration of
    predicate-free indexes."""
    assert all(i.predicate is None for i in ref_config.indexes)
    return pt.Configuration.of(
        pt.IndexDef(i.table, tuple(i.cols), i.compression, i.clustered)
        for i in ref_config.indexes)


def assert_same_steps_up_to_ping_pong(got_steps, want_steps) -> None:
    """Greedy steps equal, except that one run may go on where the other
    stopped with steps that leave the cost unchanged: the float32 greedy
    swapping two tied clustered layouts until the step limit (ROADMAP.md
    Queue C), which the two float32 backends need not both fall into."""
    k = min(len(got_steps), len(want_steps))
    assert got_steps[:k] == want_steps[:k]
    for step in (got_steps[k:] or want_steps[k:]):
        before, after = step.rsplit("cost ", 1)[1].split("->")
        assert before == after, step
