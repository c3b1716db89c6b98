"""``launch/probe_flash.py``'s variants still apply to the kernel's source.

The probe builds its diagnostic variants of ``csrc/flash_attention_sm90.cu``
by replacing pieces of its text, each of which must occur exactly once; an
edit of the head-dim-256 schedule that moves one of them would break the
probe only on the card. Here every variant the probe builds (and the
traced build with its stamps) is made from the source as it stands.
"""

import pytest

from repro_torch.kernels._build import CSRC_DIR
from repro_torch.launch import probe_flash

SOURCE = (CSRC_DIR / "flash_attention_sm90.cu").read_text()


@pytest.mark.parametrize("name,traced", [*((n, False) for n in probe_flash.VARIANTS),
                                         ("kernel", True)])
def test_probe_variant_applies_to_the_kernel_source(name, traced):
    src = probe_flash.variant_source(name, traced)
    edits = probe_flash.VARIANTS[name] + (probe_flash._STAMPS if traced else [])
    assert (src == SOURCE) == (not edits)
    for _, new in edits:
        assert new in src
    if traced:
        assert "extern \"C\" int probe_turns" in src and "TURN(5)" in src
