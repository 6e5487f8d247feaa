"""Data I/O and synthetic parameters of the port."""
