"""The paper's own experiment configs: the Table 4.1 datasets as census
jobs (counterpart of :mod:`repro.configs.triad_census`).

They parameterize :mod:`repro_torch.launch.census_dryrun` and
``examples/triad_census_sna_torch.py``; with ``path`` set to a real
Pajek or SNAP file, :func:`repro_torch.core.graph.load_pajek_or_edgelist`
takes over from the R-MAT stand-ins.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.generators import PAPER_DATASETS


@dataclasses.dataclass(frozen=True)
class CensusJobConfig:
    dataset: str
    n_vertices: int
    n_arcs: int
    directed: bool
    path: Optional[str] = None  # real dataset file (Pajek / edge list)
    strategy: str = "sorted_snake"
    weight_model: str = "canonical_uniform"
    batch: int = 256
    buckets: tuple = (64, 256, 1024)  # degree-bucket tile widths


CENSUS_JOBS: dict[str, CensusJobConfig] = {
    name: CensusJobConfig(dataset=name, n_vertices=n, n_arcs=m, directed=d)
    for name, (n, m, d) in PAPER_DATASETS.items()
}


def get_census_job(name: str) -> CensusJobConfig:
    return CENSUS_JOBS[name]
