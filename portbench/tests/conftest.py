"""The benchmark's tests: CPU tests at tiny sizes, and tests marked `card`
that need a CUDA card (each decides inside itself, and skips without one).

    python -m pytest portbench/tests -q -p no:randomly    # here: card tests skip
    python -m pytest portbench/tests -q -m card           # on the card
"""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
