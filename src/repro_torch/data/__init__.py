"""Datasets (synthetic paper Table 4 series) and the NARMA10 fixtures."""
from repro_torch.data.timeseries import (PAPER_DATASETS, drift_segment_bounds,
                                        load, make_dataset,
                                        make_drift_label_streams,
                                        make_narma10)

__all__ = ["PAPER_DATASETS", "drift_segment_bounds", "load", "make_dataset",
           "make_drift_label_streams", "make_narma10"]
