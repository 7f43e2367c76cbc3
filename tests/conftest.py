"""Test config: force the CPU with 8 virtual devices so the multi-device
sharding tests run anywhere (SURVEY.md §4 point 4). Tests marked ``gpu``
need the card and skip here."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
