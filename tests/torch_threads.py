"""The port's test modules run torch's host ops on one intra-op thread.

The port's CPU paths are many small ops (threefry draws in int64 tensor
ops, smoke-size models, optimizer steps leaf by leaf).  Split over the
intra-op pool, every op waits at the pool's barrier, and where a test
runner's workers share the cores those waits dominate, by an order of
magnitude.  A module imports :func:`one_thread` to take it as an autouse
fixture; the thread count comes back when the module ends.
"""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
