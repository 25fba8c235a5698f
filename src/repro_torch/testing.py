"""Test-only helpers for the port's tests on the CPU.

`pytest -n 6` runs six workers on one host; with torch's default intra-op
pool each of them starts one thread a core, and the workers' threads then
fight over the same cores (a test that takes 13 s alone took 297 s beside
five such workers). Every `tests/test_torch_*.py` calls `limit_threads()`
at import, so each worker that runs the port's tests keeps to
`TEST_THREADS` threads. Spawned mesh ranks set their own count
(`launch.mesh_train.run_job`, `launch.mesh_serve.run_serve_jobs`).

    from repro_torch.testing import limit_threads
    limit_threads()
"""
from __future__ import annotations

import torch

# torch's intra-op threads in a test worker. 1 and 2 were measured on the
# port's test files under `pytest -n 6 --dist loadfile` on 8 cores: the
# figures are in CHANGES.md.
TEST_THREADS = 1


def limit_threads(n: int = TEST_THREADS) -> int:
    """Set torch's intra-op thread count for this process; returns it."""
    if torch.get_num_threads() != n:
        torch.set_num_threads(n)
    return torch.get_num_threads()
