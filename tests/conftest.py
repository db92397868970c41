import os

# Simulate an 8-device mesh on CPU for sharding tests. XLA_FLAGS must be in
# the environment before the jax backend initializes; the tests run on the
# CPU whatever accelerator the host has.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
