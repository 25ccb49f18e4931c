"""One reader a metric, ``<metric>.py``, found by the metric's name in
``BENCHMARK.json``.  ``read(run)`` returns the number, or None when the run
holds nothing to read (the metric is then left out of the line; a share of
a peak is never reported as 0).  An optional ``probe(run, handles)`` runs in
a traced run while the program is still alive."""
