"""Configurations of the JAX package and their port twins with one
insertion history.

Both packages' `CostEngine.split` (and so `config_cost`) sum a table's
update costs in the iteration order of `Configuration.indexes`, a
frozenset. Two frozensets of equal content but different insertion
histories may iterate differently under some hash seeds, which moves a
float64 total by an ulp or so. Building the reference configuration and
its twin from one list, sorted by `label()`, gives both sets the same
history: with equal element hashes they iterate alike under every
seed."""
import repro.core as rc
import repro_torch.core as pt
from repro_torch.core.relation import IndexDef, Predicate


def port_index(i):
    pred = None if i.predicate is None else Predicate(
        i.predicate.col, i.predicate.lo, i.predicate.hi)
    return IndexDef(i.table, tuple(i.cols), i.compression, i.clustered, pred)


def twin_configs(ref_configs):
    """([reference configuration], [port configuration]), each pair built
    from one label-sorted list of the given configuration's indexes."""
    refs, ports = [], []
    for c in ref_configs:
        lst = sorted(c.indexes, key=lambda i: i.label())
        twins = [port_index(i) for i in lst]
        assert all(hash(i) == hash(j) for i, j in zip(lst, twins))
        refs.append(rc.Configuration.of(lst))
        ports.append(pt.Configuration.of(twins))
    return refs, ports
