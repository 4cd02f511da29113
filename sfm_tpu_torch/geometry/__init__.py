"""Camera models, SO(3), projection and robust losses (port of sfm_tpu/geometry)."""
