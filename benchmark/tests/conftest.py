"""Registers the marker of the tests that need the card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skipped, with a reason, "
        "where torch.cuda.is_available() is False (decided in the test)")
