"""Data-parallel training over ray shards (port of umhs_tpu/parallel)."""
