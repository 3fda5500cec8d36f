"""One reader a metric: ``<name up to the first dot>.py`` with
``read(run) -> float | None``; None when the run holds nothing to read."""
