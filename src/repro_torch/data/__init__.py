"""Datasets (synthetic paper Table 4 series)."""
from repro_torch.data.timeseries import PAPER_DATASETS, load, make_dataset

__all__ = ["PAPER_DATASETS", "load", "make_dataset"]
