import asyncio
import inspect
import os
import sys

import pytest

# Multi-chip sharding tests run on a virtual 8-device CPU mesh; set the flags
# before any jax import (only the jax-marked tests import jax at all).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# Minimal async test support (pytest-asyncio is not in this image): coroutine
# tests and async(-generator) fixtures run on a per-test event loop.
# ---------------------------------------------------------------------------


@pytest.fixture
def event_loop():
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    yield loop
    loop.run_until_complete(loop.shutdown_asyncgens())
    loop.close()
    asyncio.set_event_loop(None)


@pytest.hookimpl(tryfirst=True)
def pytest_fixture_setup(fixturedef, request):
    func = fixturedef.func
    if not (inspect.isasyncgenfunction(func) or inspect.iscoroutinefunction(func)):
        return None
    loop = request.getfixturevalue("event_loop")
    kwargs = {
        name: (request if name == "request" else request.getfixturevalue(name))
        for name in fixturedef.argnames
    }
    if inspect.isasyncgenfunction(func):
        agen = func(**kwargs)
        value = loop.run_until_complete(agen.__anext__())

        def _finalize():
            try:
                loop.run_until_complete(agen.__anext__())
            except StopAsyncIteration:
                pass

        fixturedef.addfinalizer(_finalize)
    else:
        value = loop.run_until_complete(func(**kwargs))
    fixturedef.cached_result = (value, fixturedef.cache_key(request), None)
    return value


@pytest.hookimpl(tryfirst=True)
def pytest_pyfunc_call(pyfuncitem):
    func = pyfuncitem.obj
    if not inspect.iscoroutinefunction(func):
        return None
    loop = pyfuncitem._request.getfixturevalue("event_loop")
    sig_params = inspect.signature(func).parameters
    kwargs = {
        name: pyfuncitem.funcargs[name]
        for name in sig_params
        if name in pyfuncitem.funcargs
    }
    loop.run_until_complete(func(**kwargs))
    return True


def pytest_configure(config):
    config.addinivalue_line("markers", "asyncio: asyncio-based test")
    config.addinivalue_line(
        "markers", "slow: long-running test, excluded from the tier-1 gate")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")
