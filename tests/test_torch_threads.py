"""One intra-op thread for torch in each test process.

The tier-1 command runs the suite in 6 xdist workers on one box. By
default torch runs its CPU kernels on an OpenMP pool of one thread per
core in every worker, so six pools of spinning threads share the cores:
``test_torch_recipes.py::test_recipe_cli_runs_every_hook_and_resumes``
takes 21 s alone and took 846 s with five copies of itself beside it, and
21 s each with one thread per copy (8 cores). The port's test models are
small: one thread runs them as fast as eight when alone.

Every xdist worker imports every test module when it collects, so this
module's import sets the count for each worker before any test runs, and
``OMP_NUM_THREADS`` for the processes that tests start (the CLI
subprocesses, the gloo ranks).
"""
import os

import torch

os.environ["OMP_NUM_THREADS"] = "1"
torch.set_num_threads(1)


def test_torch_runs_one_thread_per_process():
    assert torch.get_num_threads() == 1
    assert os.environ["OMP_NUM_THREADS"] == "1"
