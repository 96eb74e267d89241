"""The benchmark of warpedganspace_torch: one cell of BENCHMARK.json run once
(``python -m benchmark.run``), driven by data files found by name."""
