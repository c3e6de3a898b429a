"""python -m rust_raytracer_torch [scene|file.dsl|model:path] -k=v ... (utils/cli.py)"""
import sys

from .utils.cli import main

if __name__ == "__main__":
    sys.exit(main())
