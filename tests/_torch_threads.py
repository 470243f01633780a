"""Caps torch's intra-op threads in a test process.

Under ``pytest -n N`` each of the N worker processes would run torch with
one intra-op thread per core, so N processes contend for every core and a
CPU-bound test runs many times slower than alone.  Importing this module
gives each worker ``cores // N`` threads (``PYTEST_XDIST_WORKER_COUNT`` is
set by xdist in its workers; 1 without xdist, so a lone process keeps
every core).  Every ``tests/test_torch_*.py`` imports it before its torch
work; the name does not match ``test_*.py``, so pytest does not collect it.
"""

import os

import torch

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
