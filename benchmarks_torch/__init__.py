"""Benchmarks of the PyTorch port (``repro_torch``): the twins of
``benchmarks/bench_ridge.py`` (paper Tables 2, 3, 8 and Fig. 9) and
``benchmarks/bench_truncation.py`` (Table 7).  Each module's ``run``
returns the reference's rows; run one from the repository root with
``PYTHONPATH=src python -m benchmarks_torch.bench_ridge``."""
