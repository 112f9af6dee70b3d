"""Schema and foreign keys (paper Appendix B's join-synopsis substrate).

Only `Schema` and `ForeignKey` are ported; filtered samples, join synopses
and MV samples (the JAX package's `synopses.SynopsisManager`) are not on
the advisor's main path yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

from .relation import Table


@dataclasses.dataclass(frozen=True)
class ForeignKey:
    fact_table: str
    fk_col: str
    dim_table: str
    dim_key: str


class Schema:
    def __init__(self, tables: Dict[str, Table],
                 foreign_keys: Sequence[ForeignKey] = ()):
        self.tables = dict(tables)
        self.foreign_keys = tuple(foreign_keys)

