"""Utility substrate: image I/O, artifact handling, timing, stats.

The replacement for the reference's L0/L2 layers
(``src/util.h``, ``src/image.c``, vendored ``stb_image.h``).
"""
