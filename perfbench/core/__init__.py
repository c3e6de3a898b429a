"""The benchmark harness of rust_raytracer_torch: the runner, the trace reader and the comparison with the plain reference."""
