"""The port's benchmark: one cell of ``BENCHMARK.json`` run once per call.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it: ``configs/<config>.json``, ``mixes/<traffic>.json`` (read by the
driver the mix names under ``drivers/``), ``metrics/<metric>.py``.
"""
