"""Scenes as the reference builds them, one module a scene, found by name."""
