"""Batched MultiGrid engine (port of dcd_isaac_tpu/envs/multigrid)."""
