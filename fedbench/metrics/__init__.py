"""One reader a metric, ``<name>.py`` with ``read(run) -> float | None``:
``run`` is the run's record (``fedbench/run.py:Record``). A reader that
finds nothing to read returns None and the metric is left out."""
