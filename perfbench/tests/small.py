"""Cells cut to a size the CPU runs in seconds: a small image, a small
pool, a small torus knot (the program's built-in cornell_dragon is patched
to build the same small knot that the reference's scene module is told
to build)."""
import functools

from perfbench.core import spec

KNOT = {"rings": 40, "segments": 16}

def small_cell(name: str, monkeypatch, width: int = 16, lanes: int = 2048, shards: int = 1,
               **root):
    """Cell `name` cut small; with `shards` > 1, its renders over a mesh of
    that many shards (on the CPU), as a four-card cell would run them."""
    from rust_raytracer_torch.utils import procgen

    monkeypatch.setattr(procgen, "torus_knot_mesh",
                        functools.partial(procgen.torus_knot_mesh, **KNOT))
    cell = spec.load_cell(name, **root)
    cell.config["camera"]["image_width"] = width
    cell.config["shards"] = shards
    cell.config.update(knot_rings=KNOT["rings"], knot_segments=KNOT["segments"],
                       lanes=lanes * shards)
    if "check_pixels" in cell.traffic:
        cell.traffic["check_pixels"] = min(cell.traffic["check_pixels"], 48)
    if "lanes" in cell.traffic:
        cell.traffic["lanes"] = 256
    cell.traffic["trace_units"] = 1
    if cell.traffic["loop"] == "renders":
        cell.config["samples_per_pixel"] = 4
    return cell
