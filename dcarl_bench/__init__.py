"""The benchmark of ``dcarl_tpu_torch``, the PyTorch and CUDA port.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration in ``configs/<config>.json``, its traffic in
``workloads/<traffic>.json``, the code of its entry point in
``entries/<entry>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``.  The plain reference that decides ``correct``
lives in ``reference/`` and imports nothing of the port.
"""
