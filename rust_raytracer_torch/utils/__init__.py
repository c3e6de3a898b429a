# Submodules imported directly (rust_raytracer_torch.utils.assets, ...).
