"""Reconstruction state (port of sfm_tpu/scene)."""
