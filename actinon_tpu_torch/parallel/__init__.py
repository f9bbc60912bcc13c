"""Multi-device rendering (`parallel/mesh.py`)."""
