"""The benchmark's own code: it reads ``BENCHMARK.json``, makes each cell's
inputs from the seed, times the window, reduces the profiler's trace and
decides ``correct`` against the plain reference in ``perfbench/reference``.

Nothing here imports JAX or the JAX package; the program under test is the
PyTorch port (``repro_torch``), reached only through ``perfbench/entries``.
"""
