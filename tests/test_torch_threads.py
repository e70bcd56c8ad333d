"""One share of the host's cores for torch in each pytest-xdist worker.

Torch keeps a pool of one intra-op thread per core in every process. With
the suite run as ``pytest -n 6`` on an 8-core host, six workers then spin 48
threads on 8 cores, and every subprocess a test starts adds 8 more. Measured
on such a host: the miniature card loop of
``test_torch_obs_regional.py`` took 545.8 s inside a whole run and 7.7 s
alone, ``test_torch_train_launch.py::test_training_loss_decreases`` 230.8 s
and 7.6 s; six copies at once finished in 10.8 s and 8.9–10.0 s with one
thread each, and not within 110 s and 150 s at torch's default.

So inside a worker, when this module is imported, torch gets the worker's
share of the cores the process may run on, and ``OMP_NUM_THREADS`` says
the same to every subprocess a test starts. Each worker imports every test
module while it collects, before it runs any test, so the setting holds for
the whole run. Outside xdist nothing changes. The setting belongs in
``tests/conftest.py``; it lives in a test module of the port because the
port's changes have so far left the files that predate it as they were.
"""
import os

import pytest

torch = pytest.importorskip("torch")

THREADS = (max(1, len(os.sched_getaffinity(0))
               // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
           if "PYTEST_XDIST_WORKER" in os.environ else None)
if THREADS is not None:
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)


def test_a_worker_runs_torch_on_its_share_of_the_cores():
    if THREADS is None:
        pytest.skip("not inside a pytest-xdist worker: nothing is set")
    assert torch.get_num_threads() == THREADS
    assert os.environ["OMP_NUM_THREADS"] == str(THREADS)
