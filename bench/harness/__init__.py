"""The benchmark's general code: the index and its files (``spec``), the
weights (``weights``), one run (``runner``), the benchmark's probes and
the profiler's reading (``probes``, ``trace``), the correctness check
(``check``), the peaks and the statistics."""
