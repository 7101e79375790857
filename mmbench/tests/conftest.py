"""CPU tests of the benchmark (``python -m pytest mmbench/tests``); the tests marked ``cuda``
need the card and skip elsewhere (on the card: ``python -m pytest -m cuda mmbench/tests``)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Four intra-op threads: the plain stages' CPU runs share the host with other work."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest -m cuda mmbench/tests)")
    return torch.device("cuda", 0)
