"""CPU tests of the benchmark; run from the root of a checkout with
``python -m pytest zkbench/tests -q``.  None needs the card: the benchmark's
own runs and ``zkbench/control.py`` are what run there."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    import torch

    torch.set_num_threads(1)
