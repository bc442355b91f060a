"""Command-line entry points: the live server."""
