import os
import sys

# NOTE: no XLA_FLAGS here — smoke tests and benches must see exactly 1
# device.  Multi-device tests spawn subprocesses with their own flags
# (see tests/subscripts/).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA H100 (sm_90); skips without one")
