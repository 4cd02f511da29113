"""Stage drivers and the end-to-end pipeline (port of sfm_tpu/pipeline)."""
