"""Shim package: reference path ``edge/parameter_tuning/``."""
