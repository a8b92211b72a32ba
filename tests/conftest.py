import jax

# The MPC core needs uint64 lanes; model code is dtype-explicit so this is
# safe to set globally for the test session. (dryrun.py manages its own
# device-count env and is NOT imported here — smoke tests must see 1 device.)
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped without one")
