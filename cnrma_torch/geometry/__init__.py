"""Host-side geometry of the port: boxes and the TSDF container."""
