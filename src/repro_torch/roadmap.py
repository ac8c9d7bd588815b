"""Pointers into ROADMAP.md's Queue A, by the items' bold titles.

The port's NotImplementedError messages name the ROADMAP item that will
lift them through these constants; a title, unlike an item number, does
not go stale when the queue is reordered, and
tests/test_torch_system.py checks that ROADMAP.md still has each one.
"""


def _item(title: str) -> str:
    return f'ROADMAP.md Queue A, "{title}"'


PARAM_SHARDING = _item("Parameter sharding over several cards")
