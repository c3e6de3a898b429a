"""The benchmark of rust_raytracer_torch (see perfbench/run.py)."""
