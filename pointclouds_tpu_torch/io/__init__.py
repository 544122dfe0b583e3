"""Point cloud file readers and writers (PCD, PLY, LAS), numpy code."""
