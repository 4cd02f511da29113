"""Feature, matching and two-view geometry stages (port of sfm_tpu/ops)."""
