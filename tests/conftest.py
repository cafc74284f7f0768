"""Test config: eight virtual CPU devices for the mesh and sharding tests.

The same mesh/sharding/collective code that runs across cards runs here in
one process on virtual host devices (SURVEY.md §4 "fake backend"). The
kernel wrappers run their plain XLA forms on the CPU; tests that need the
card are marked ``gpu`` and skip here (see tests/test_gpu_kernels.py).
XLA_FLAGS must be set before ``import jax``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
