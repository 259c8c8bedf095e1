"""The paper's own DFR configurations (Sec. 4.1): Nx=30, linear f,
p=q=0.01 init, 25 epochs, the beta sweep - one preset per Table 4 dataset.
A copy of ``repro.configs.dfr_paper``.
"""
from repro_torch.core.types import DFRConfig
from repro_torch.data.timeseries import PAPER_DATASETS


def paper_dfr_config(dataset: str, n_nodes: int = 30) -> DFRConfig:
    spec = PAPER_DATASETS[dataset.upper()]
    return DFRConfig(
        n_in=spec.n_in,
        n_classes=spec.n_classes,
        n_nodes=n_nodes,
        nonlinearity="linear",
    )
