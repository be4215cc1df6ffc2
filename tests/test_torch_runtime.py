"""Twins of ``tests/test_runtime.py``: each of its tests (every
parametrised case) runs through the JAX package's ``repro.core`` and
through the port's ``repro_torch.core`` (``device="cpu"``) on the same
seeds. Its own assertions hold on both sides, and the stacks, sockets,
runtimes and policy tables it builds end with identical wire bytes,
``CopyCounters``, page counts and channel stats (``tests/_twin.py``)."""
import pytest

import _twin

PATH = _twin.TESTS / "test_runtime.py"


@pytest.mark.parametrize("case", _twin.cases(PATH), ids=_twin.case_id)
def test_runtime_twin(case):
    name, params = case
    _twin.run(PATH, name, **params)
