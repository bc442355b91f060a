"""Host I/O: the MARK container."""
