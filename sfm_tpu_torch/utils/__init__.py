"""Timers, numpy-only synthetic scenes and the numpy interop with sfm_tpu."""
