"""Detector engines."""
