import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    """The tiny cells run op by op: one thread each is fastest, and the
    ranks of a multi-rank test do not contend for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
