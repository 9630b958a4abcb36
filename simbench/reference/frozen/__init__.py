"""Frozen plain-torch copies of the program's physics step and rasterizer (see each file's header)."""
