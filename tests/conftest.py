"""Shared test configuration: hypothesis profiles.

The ``ci`` profile (selected via ``HYPOTHESIS_PROFILE=ci`` in the GitHub
workflow) runs many more examples with no deadline — CI machines are slow
and shared, so wall-clock deadlines flake, while the extra examples are
exactly what an unattended run is for. Per-test ``@settings`` fields still
take precedence where they are explicitly set; the profile fills the rest.
"""

import os

try:
    from hypothesis import settings
except ImportError:  # hypothesis is optional locally; tests importorskip it
    settings = None

if settings is not None:
    settings.register_profile("ci", max_examples=300, deadline=None)
    settings.register_profile("dev", max_examples=25, deadline=None)
    _profile = os.environ.get("HYPOTHESIS_PROFILE")
    if _profile:
        settings.load_profile(_profile)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips (with its reason) without one")
