"""Example environments for tests and docs (reference: rllib/examples/).
Copies of ray_tpu/rllib/examples/ (numpy only)."""
