"""One torch thread for each port test module (`one_torch_thread`).

The tier-1 suite runs six pytest-xdist workers on the host's cores, and
torch's OpenMP pool takes one thread per core in every worker: six
concurrent copies of one small MASRTrainer test took 187 s each with
torch's default 8 threads and 7-9 s with one (against 6 s for one copy
alone). Each tests/test_torch_*.py imports this autouse, module-scoped
fixture, which runs the module's tests on one torch thread and gives the
worker its previous count back after the module; the JAX package's tests
keep theirs. Results do not depend on it beyond f32 sum order."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_module_runs_on_one_torch_thread():
    """The fixture holds inside a module that uses it (this one)."""
    assert torch.get_num_threads() == 1
