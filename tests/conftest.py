import os

# Tests run on the CPU: force JAX onto a virtual 8-device CPU mesh so
# the sharding logic is exercised the way a multi-device mesh runs it.
# The config update also covers a jax that was imported before this
# file. Tests that need a GPU (marker "gpu") run the card from a
# subprocess, so this process never opens it.
os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
  os.environ["XLA_FLAGS"] = (
    xla_flags + " --xla_force_host_platform_device_count=8"
  ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
