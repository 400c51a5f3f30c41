"""One reader per metric: ``<name>.py`` holds `read(run)`, which returns
the metric's value from a finished run (a `benchmark.run.Run`), or None
where the run holds nothing to read it from. A metric named ``base.suffix``
(``read_ms_per_batch.album``) is read by ``base.py``; the suffix names the
cells it is reported in."""
