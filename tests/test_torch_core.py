"""Twins of ``tests/test_core.py``, its parsers, VPI registry, allocator
and proxy flows: each of its tests (every parametrised case; each
hypothesis example drawn once and replayed on the port) runs through the
JAX package's ``repro.core`` and through the port's ``repro_torch.core``
on the same seeds. Its own assertions hold on both sides, and the
objects it builds end the same (``tests/_twin.py``)."""
import pytest

import _twin

PATH = _twin.TESTS / "test_core.py"


@pytest.mark.parametrize("case", _twin.cases(PATH), ids=_twin.case_id)
def test_core_twin(case):
    name, params = case
    _twin.run(PATH, name, **params)
