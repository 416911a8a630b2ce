"""Benchmark harnesses of the port. :mod:`petastorm_tpu_torch.benchmark.trend` is the
throughput-regression gate (``python -m petastorm_tpu_torch.benchmark.trend``)."""
