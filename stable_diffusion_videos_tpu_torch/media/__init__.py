"""Frame files (PNG) and video assembly for the walk (host only)."""
