"""The port's configs are copies of the reference's: every arch and its
``.reduced()`` agree field for field."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402


def test_same_arch_names():
    assert list(ARCHS) == list(REF_ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_arch_fields_equal(arch):
    ref, port = REF_ARCHS[arch], ARCHS[arch]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert port.param_count() == ref.param_count()
    assert [dataclasses.asdict(s) for s in port.period_spec()] == \
        [dataclasses.asdict(s) for s in ref.period_spec()]
