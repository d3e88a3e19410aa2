import hashlib
import os

# Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
# on the CPU. jax.config.update also covers a process that imported jax
# before this file ran.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["XLA_FLAGS"] = flags

# Process-survival note: the XLA:CPU parallel thunk executor can abort()
# in a collective rendezvous on the 8-virtual-device mesh (sharded
# inverse-step grad test). Such tests run in fresh subprocesses via
# tests/_isolate.py's decorator (the pattern test_multiprocess.py already
# uses), which keeps `python -m pytest tests/ -q` green in one process.

import jax  # noqa: E402

from kazen_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite is compile-bound on CPU (big
# unrolled integrator graphs), so warm re-runs of unchanged code drop from
# minutes to seconds. Without JAX_COMPILATION_CACHE_DIR the in-checkout
# default gets a subdirectory per host and jaxlib: XLA:CPU executables are
# machine-specific, and entries compiled on another host with other CPU
# feature preferences have loaded here as silently wrong renders.
_key = ""
for _f in ("/proc/cpuinfo", "/etc/machine-id"):
    try:
        with open(_f) as f:
            _key += next((l for l in f if l.startswith("flags")), f.read())
    except OSError:
        _key += "absent"
_key += getattr(__import__("jaxlib"), "__version__", "") + os.uname().nodename
enable_compile_cache(f"cpu-{hashlib.sha1(_key.encode()).hexdigest()[:12]}")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_enable_xla_caches", "all")


import pytest  # noqa: E402


@pytest.fixture
def kernel_walk(monkeypatch):
    """Route BVH traces through the GPU walk kernel in interpret mode."""
    import functools

    from kazen_tpu.accel import backend
    from kazen_tpu.accel.bvh_kernel import intersect_bvh_kernel

    walk = functools.partial(intersect_bvh_kernel, interpret=True)
    monkeypatch.setattr(backend, "bvh_walk", lambda platform=None: walk)
    jax.clear_caches()  # no jitted program may keep the other walk
    yield walk
    jax.clear_caches()
