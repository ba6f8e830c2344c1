"""The benchmark of recnet_tpu_torch on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix or per-layer metric is a file of
its own, found by the name the manifest gives it: ``configs/<config>.json``,
``traffic/<traffic>.json`` (read by the generator ``drivers/<kind>.py`` its
``kind`` names), ``metrics/<metric>.py`` and ``limits/<workload>.json``.
The yardstick stays here: the work counts and peaks (``work.py``), the
trace reader (``trace.py``), the seeded inputs (``seeded.py``) and the
plain reference (``reference/``) with the comparison that decides
``correct`` (``oracle.py``).
"""
