"""The benchmark of the PyTorch/CUDA port of himan.

``python3 port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` on the CUDA card it is started on and
prints one JSON line. Everything a cell needs is found by name: its
configuration in ``configs/``, its traffic mix in ``traffic/``, the limits
of its correctness check in ``limits/`` and each per-layer metric's reader
in ``metrics/``. The plain reference that decides ``correct`` is in
``reference/`` and imports nothing of the port; each model there is the
module that declares the configuration's ``model`` (``reference/registry.py``),
with its counts for ``flops.py``.
"""
