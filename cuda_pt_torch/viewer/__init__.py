"""The interactive web viewer (viewer/server.py)."""
