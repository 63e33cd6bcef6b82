"""Dataset reading of the port: the ScanNet reader and its transforms."""
