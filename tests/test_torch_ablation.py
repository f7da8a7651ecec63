"""line_tile_ablation.py's variants: each substitution's text is in the
kernel source it names (once edited away, a variant would fail to build
on the card), and each variant changes its source."""

import pytest

import line_tile_ablation as la
from transit_tpu_torch.opacities import _build


@pytest.mark.parametrize("suite", sorted(la.ABLATIONS))
def test_ablation_substitutions_name_source_text(suite):
    sources = {s.name: s.read_text() for s in _build.sources()}
    for name, (what, subs) in la.ABLATIONS[suite].items():
        assert what and subs, name
        for src, pairs in subs.items():
            for old, new in pairs:
                assert old in sources[src], (suite, name, src, old)
                assert old != new, (suite, name)
