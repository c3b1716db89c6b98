"""Operator tools for a store: ``fsck`` (check and repair), ``nstat``
(metrics and space dashboard) and ``hillclimb`` (dry-run cells).

Each runs as ``python -m repro_torch.tools.<name>`` and keeps the flags,
output text and exit codes of the reference's ``tools/<name>.py``, with
``--device`` (default ``cuda``, which exits with the engine's error where
there is no card; ``cpu`` selects the plain path).
"""
