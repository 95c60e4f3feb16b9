"""The pipeline configuration, shared with the JAX package.

``caelo_tpu/config.py`` is frozen dataclasses with no JAX in its import
chain, so the port imports it rather than keeping a copy that could drift.
"""
from caelo_tpu.config import (IcpConfig, KeypointConfig,  # noqa: F401
                              PipelineConfig, RansacConfig, RefineConfig,
                              SensorConfig, VoxelConfig, tiny_test_config)
